"""Frames analysed to a concentration map per second, over all the frames
and all the time of the window (host clock)."""


def read(rec):
    if "frames" not in rec or rec["window_s"] <= 0:
        return None
    return rec["frames"] / rec["window_s"]
