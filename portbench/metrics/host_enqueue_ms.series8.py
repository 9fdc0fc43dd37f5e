"""Host milliseconds per frame spent in the program's call until it returns,
before any synchronisation (the generator's own host clock around each call;
the traced calls left out): the host's dispatch of the frame's work."""

from portbench.common import mean_enqueue_ms


def read(rec):
    return mean_enqueue_ms(rec)
