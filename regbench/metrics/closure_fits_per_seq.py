"""Frame models the loop closures fit a sequence (the program's closure.fits
counter: each frame a verification registers onto, fitted again although
the chain fitted the same model), the median over the sequences traced
inside profiling.tracing()."""

import statistics


def read(record):
    v = record.get("backend", {}).get("closure_fits")
    return statistics.median(v) if v else None
