"""CG trips per Newton iteration in the traced batched solve: the
program's ``beckmann.cg_trips`` counted inside its ``beckmann.solve`` span
(the Darcy start's pressure solve included) over its ``beckmann.newton``
spans.  A trip is one execution of the CG loop's body for the batch."""

from portbench.spans import below, cg_trips, traced_solves


def read(rec):
    got = traced_solves(rec)
    if got is None:
        return None
    spans, solves = got
    newton = [s for s in below(spans, solves) if s.name == "beckmann.newton"]
    trips = cg_trips(spans, solves)
    return trips / len(newton) if newton and trips else None
