"""Card idle time inside the program's ``encode.launch`` spans (K1, LOX, K2
and the byte cut launched), summed over the traced window's compress calls,
in ms per MiB of their input."""

from codec_bench import spans


def read(run):
    return spans.idle_ms_per_MiB(run, "launch")
