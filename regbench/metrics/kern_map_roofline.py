"""The least time the card could take for the map's tree fit at its live
points (the fused cloud, at most the bucket; regbench/harness/roofline.py's
fit_tree), as a share of the device's busy time of the work launched inside
the program's hgmm_torch.map.fit span of the profiled sequence, matched by
correlation id."""


def read(record):
    p = record.get("profile")
    if not p or not p.get("map_bound_s") or p.get("map_fit_busy_s", 0) <= 0:
        return None
    return 100.0 * p["map_bound_s"] / p["map_fit_busy_s"]
