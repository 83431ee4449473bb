"""Host wall of the program's ``encode.stage`` spans (the halo'd rows built
on the host), the mean over the traced window's compress calls, in ms."""

from codec_bench import spans


def read(run):
    return spans.ms_per_call(run, "encode.stage")
