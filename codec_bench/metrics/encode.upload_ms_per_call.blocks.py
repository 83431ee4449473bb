"""Host wall of the program's ``encode.upload`` spans (the five arrays'
pageable copies to the card, with any wait a copy makes on the stream), the
mean over the traced window's compress calls, in ms."""

from codec_bench import spans


def read(run):
    return spans.ms_per_call(run, "encode.upload")
