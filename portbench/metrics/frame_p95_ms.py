"""95th percentile of the live frames' latency, over every frame of the
window: from just before its upload to the end of its map's copy to the
host, on the card's clock (CUDA events)."""

from portbench.common import quantile


def read(rec):
    lat = rec.get("frame_ms")
    if not lat or len(lat) < 20:
        return None
    return quantile(lat, 0.95)
