"""The median host time of the tree fit a request, ended by a device sync."""

import statistics


def read(record):
    v = record.get("spans", {}).get("fit_ms")
    return statistics.median(v) if v else None
