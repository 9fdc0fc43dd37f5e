"""Host milliseconds per traced frame in the program's ``pipeline.correct``
spans (the frames of the device-only trace after the window), from the
program's own span clock."""

from portbench.spans import stage_host_ms


def read(rec):
    return stage_host_ms(rec, "pipeline.correct")
