"""Device ms a pair in reg_stats' register-list gated body
(reg_stats_top_k_kernel, matched by name among the breakdown's device
operations) over the profiled stretch."""

KERNEL = "reg_stats_top_k_kernel"


def read(record):
    p = record.get("profile")
    if not p:
        return None
    busy = sum(s for name, s in p.get("device_ops", []) if KERNEL in name)
    return 1e3 * busy / p["pairs"] if busy > 0 else None
