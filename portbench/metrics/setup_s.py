"""Seconds from the start of the process to the first timed call: imports,
the CUDA context, the kernels' build or load, the inputs made from the seed,
the program's set-up and the warm-up."""


def read(rec):
    return rec.get("setup_s")
