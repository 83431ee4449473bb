"""Card idle time inside the program's ``encode.stage`` spans (the halo'd
rows built on the host), summed over the traced window's compress calls, in
ms per MiB of their input."""

from codec_bench import spans


def read(run):
    return spans.idle_ms_per_MiB(run, "stage")
