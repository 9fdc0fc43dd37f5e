"""Device-busy milliseconds per frame: the union of the kernel, copy and
fill intervals of the traced window, over the frames traced."""


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr.get("frames") or tr["busy_s"] <= 0:
        return None
    return 1e3 * tr["busy_s"] / tr["frames"]
