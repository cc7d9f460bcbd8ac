"""The least time the card could take for the profiled registrations'
needed work (live iterations only), as a share of the device's busy time
inside the registration spans."""


def read(record):
    p = record.get("profile")
    if not p or not p.get("reg_bound_s") or p.get("reg_busy_s", 0) <= 0:
        return None
    return 100.0 * p["reg_bound_s"] / p["reg_busy_s"]
