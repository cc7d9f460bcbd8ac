"""The median host ms a sequence in the pose-graph refinement (the program's
hgmm_torch.pg.refine span), over the sequences traced inside
profiling.tracing()."""

import statistics


def read(record):
    v = record.get("backend", {}).get("refine_ms")
    return statistics.median(v) if v else None
