"""Transport distances computed per second: all pairs over all the time of
the window (host clock, every batch closed by its results on the host)."""


def read(rec):
    if "pairs" not in rec or rec["window_s"] <= 0:
        return None
    return rec["pairs"] / rec["window_s"]
