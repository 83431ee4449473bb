"""Card idle time inside the traced window's compress calls but in none of
the spans the other four parts read (the wait for a batch's count, the
Python between spans), in ms per MiB of their input.  The five parts add up
to the card's idle time inside compress calls."""

from codec_bench import spans


def read(run):
    return spans.idle_ms_per_MiB(run, "other")
