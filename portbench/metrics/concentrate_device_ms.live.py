"""Stream milliseconds per traced frame between the CUDA events of the
program's ``pipeline.concentrate`` spans (the frames of the device-only trace
after the window): the stage's device work and any wait of the stream for
the host inside it."""

from portbench.spans import stage_device_ms


def read(rec):
    return stage_device_ms(rec, "pipeline.concentrate")
