"""Host milliseconds of the program's ``pipeline.assemble`` spans (the
series' stack, the registration's staged shifts and the packaging) in the
calls of the device-only trace after the window, over those calls' frames."""

from portbench.spans import assemble_host_ms


def read(rec):
    return assemble_host_ms(rec)
