"""Device kernels per CG trip in the traced batches: all the kernels the
device trace counts in the batches (the Newton step's own passes and the
Darcy start included) over the CG trips the program counted in their
``beckmann.solve`` spans."""

from portbench.spans import cg_trips, traced_solves


def read(rec):
    tr = rec.get("trace") or {}
    got = traced_solves(rec)
    if got is None or not tr.get("kernel_launches"):
        return None
    trips = cg_trips(*got)
    return tr["kernel_launches"] / trips if trips else None
