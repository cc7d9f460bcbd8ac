"""The whole pair's share of the card's peak, in a stretch run as the window
runs it (no profiler, no split): the seconds the float operations that the
stretch's fits and registrations need would take at their own unit's peak
(float32, the M-step and the pose solves float64; an FMA counts 2; the same
count as the kernels' rooflines), over the stretch's wall time on the host
clock. It is the needed work a pair times the rate, over the peak, and bounds
what the kernels' rooflines can claim: a kernel taken off the path leaves its
roofline silent, not this."""


def read(record):
    s = record.get("steady")
    if not s or not s.get("peak_s") or s["wall_s"] <= 0:
        return None
    return 100.0 * s["peak_s"] / s["wall_s"]
