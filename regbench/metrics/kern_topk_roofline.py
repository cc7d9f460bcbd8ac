"""The least time the card could take for the profiled requests' live passes
through reg_stats' register-list gated body (the levels that run it; the
bound of regbench/harness/roofline_gated.py), as a share of the device time
of reg_stats_top_k_kernel over the profiled stretch, matched by kernel name
among the breakdown's device operations."""

KERNEL = "reg_stats_top_k_kernel"


def read(record):
    p = record.get("profile")
    if not p or not p.get("topk_bound_s"):
        return None
    busy = sum(s for name, s in p.get("device_ops", []) if KERNEL in name)
    return 100.0 * p["topk_bound_s"] / busy if busy > 0 else None
