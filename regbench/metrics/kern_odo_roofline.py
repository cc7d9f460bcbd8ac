"""The least time the card could take for the needed work of the profiled
odometry pairs' fits and registrations, as a share of the device's busy
time over those pairs."""


def read(record):
    p = record.get("profile")
    if not p or not p.get("odo_bound_s") or p["busy_s"] <= 0:
        return None
    return 100.0 * p["odo_bound_s"] / p["busy_s"]
