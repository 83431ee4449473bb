"""Host wall of the program's ``encode.launch`` spans (K1, LOX, K2 and the
byte cut launched), the mean over the traced window's compress calls, in
ms."""

from codec_bench import spans


def read(run):
    return spans.ms_per_call(run, "encode.launch")
