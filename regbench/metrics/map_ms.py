"""The median host ms a sequence in the global map's build (the program's
hgmm_torch.map span: the fuse on the host, the bucket and the tree fit),
over the sequences traced inside profiling.tracing()."""

import statistics


def read(record):
    v = record.get("backend", {}).get("map_ms")
    return statistics.median(v) if v else None
