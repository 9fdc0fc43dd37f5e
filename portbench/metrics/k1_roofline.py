"""K1's share of its roofline over the traced window, in percent: the least
time its launches need (each launch's bytes, ``kernels/k1.py``, over the
card's peak bandwidth, ``peaks.json``) over K1's summed device time in the
trace.  The bytes are those of the lane's four launches per frame, at the
shapes the configuration runs."""

from portbench.common import kernel_time, peaks
from portbench.kernels import k1


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr.get("frames"):
        return None
    launches, seconds = kernel_time(tr, k1.NAME)
    if launches == 0 or seconds <= 0:
        return None
    least = tr["frames"] * k1.lane_bytes_per_frame(rec["config"]) / peaks(rec["device_kind"])["hbm_bytes_s"]
    return 100.0 * least / seconds
