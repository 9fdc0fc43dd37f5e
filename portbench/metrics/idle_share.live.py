"""Share of the traced window in which no kernel, copy or fill ran on the
card: 1 - (union of the device intervals) / (traced window), in percent."""

from portbench.common import idle_share_pct


def read(rec):
    return idle_share_pct(rec)
