"""The device's idle share of the profiled stretch: 100 (1 - busy / wall),
busy the union of its kernel, copy and memset intervals."""


def read(record):
    p = record.get("profile")
    if not p or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["wall_s"])
