"""Card idle time inside the program's ``encode.write`` spans (each batch's
payload copied from the fetch buffer into the returned stream, the seam
byte OR-ed in), summed over the traced window's compress calls, in ms per
MiB of their input.  A part of what ``encode.idle_ms_per_MiB.other``
reads.  None where the program has no such span."""

from codec_bench import spans

NAME = "encode.write"


def read(run):
    calls = spans.compress_calls(run)
    if not calls:
        return None
    mib = sum(c.nin for c, _, _ in calls) / spans.MIB
    # each span clipped to its call, as the other parts' are
    iv = [(max(t0, s.t0), min(t1, s.t1))
          for _, s, ps in calls for name, t0, t1 in ps if name == NAME]
    if not iv or not mib:
        return None
    return spans.idle_ns(spans.busy_pieces(run.view), iv) / 1e6 / mib
