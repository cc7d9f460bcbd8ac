"""The least time the card could take for the profiled fits' needed work,
as a share of the device's busy time inside the fit spans."""


def read(record):
    p = record.get("profile")
    if not p or not p.get("fit_bound_s") or p.get("fit_busy_s", 0) <= 0:
        return None
    return 100.0 * p["fit_bound_s"] / p["fit_busy_s"]
