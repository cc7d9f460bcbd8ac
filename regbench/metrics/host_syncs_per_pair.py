"""Operations that made the host wait for the device, a pair, as torch's
sync debug mode counts them on pairs outside the profiled stretch."""


def read(record):
    s = record.get("syncs")
    if not s or not record.get("profile"):
        return None
    return s["syncs"] / s["pairs"]
