"""The median host ms a sequence in the loop closures (the program's
hgmm_torch.odo.closures span: proposal, and each candidate's fits and
registrations), over the sequences traced inside profiling.tracing()."""

import statistics


def read(record):
    v = record.get("backend", {}).get("closure_ms")
    return statistics.median(v) if v else None
