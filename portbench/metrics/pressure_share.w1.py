"""Share of the traced batched solve's stream time spent in its pressure
solves, in percent: stream ms between the CUDA events of the program's
``beckmann.pressure`` spans over those of its ``beckmann.solve`` span."""

from portbench.spans import below, traced_solves


def read(rec):
    got = traced_solves(rec)
    if got is None:
        return None
    spans, solves = got
    pressure = [s.device_ms for s in below(spans, solves) if s.name == "beckmann.pressure"]
    total = [s.device_ms for s in solves]
    if not pressure or any(t is None for t in pressure + total) or sum(total) <= 0:
        return None
    return 100.0 * sum(pressure) / sum(total)
