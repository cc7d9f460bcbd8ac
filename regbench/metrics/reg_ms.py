"""The median host time of the registration a request, ended by a device
sync."""

import statistics


def read(record):
    v = record.get("spans", {}).get("reg_ms")
    return statistics.median(v) if v else None
