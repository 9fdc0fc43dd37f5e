"""Device kernels launched per batched solve, counted in the profiler trace
of the traced batches."""


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr.get("batches") or tr["kernel_launches"] <= 0:
        return None
    return tr["kernel_launches"] / tr["batches"]
