"""Card idle time inside the program's ``encode.upload`` and
``encode.fetch`` spans (the pageable copies to and from the card, with any
wait a copy makes on the stream), summed over the traced window's compress
calls, in ms per MiB of their input."""

from codec_bench import spans


def read(run):
    return spans.idle_ms_per_MiB(run, "copy")
