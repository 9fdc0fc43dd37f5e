"""Share of the traced batched solve's CG trips that the pressure solve's
hand-written kernels ran, in percent: the program's
``beckmann.mg_kernel_trips`` over its ``beckmann.cg_trips``, both counted
inside its ``beckmann.solve`` spans and under them.  A program whose
pressure solves count ``beckmann.mg_kernel_trips`` (0 where the tensor CG
ran) reads 0 when no trip ran in the kernels; a program without that
counter leaves the metric out."""

from portbench.spans import below, traced_solves

KERNEL = "beckmann.mg_kernel_trips"


def read(rec):
    got = traced_solves(rec)
    if got is None:
        return None
    spans, solves = got
    tree = list(solves) + below(spans, solves)
    trips = sum(s.counts.get("beckmann.cg_trips", 0) for s in tree)
    if not trips or not any(KERNEL in s.counts for s in tree):
        return None
    return 100.0 * sum(s.counts.get(KERNEL, 0) for s in tree) / trips
