"""Host wall of the program's ``encode.wait`` spans (blocked until a
batch's count and exit entry are back), the mean over the traced window's
compress calls, in ms."""

from codec_bench import spans


def read(run):
    return spans.ms_per_call(run, "encode.wait")
