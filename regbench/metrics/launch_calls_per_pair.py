"""Host calls that put work on the device's queue (kernel and graph
launches, copies, memsets) in the profiled stretch, a pair. A CUDA graph is
one call, however many kernels it holds."""


def read(record):
    p = record.get("profile")
    if not p or p["launch_calls"] == 0:
        return None
    return p["launch_calls"] / p["pairs"]
