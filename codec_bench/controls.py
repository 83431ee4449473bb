"""The control and the planted faults: each wraps the system under test so
that it breaks one guarantee, and ``correct`` has to come out false.

The codec is exact integer work and states no precision, so the control
breaks the guarantee the configurations state, the true longest match over
the whole window ``sb``: ``half-window`` compresses with a window of
``sb // 2 + 2`` (the same offset width, half the match work, the step that
would tempt a faster encoder) and writes the configuration's header, so the
stream decodes to the input and only the matches are worse.  The faults are
those a codec call can have: a token altered where it is produced, half of
the input left out, and a decoded byte altered.  ``run.py --control NAME``
runs one on the card; the benchmark's own runs never do.
"""

from __future__ import annotations

from . import reference


class _Wrap:
    def __init__(self, system):
        self.system = system

    def stats(self):
        return self.system.stats()

    def compress(self, data, la, sb, stats):
        return self.system.compress(data, la, sb, stats)

    def decompress(self, stream):
        return self.system.decompress(stream)


class HalfWindow(_Wrap):
    def compress(self, data, la, sb, stats):
        stream = self.system.compress(data, la, sb // 2 + 2, stats)
        return reference.header(la, sb) + stream[4:]


class TokenAltered(_Wrap):
    """The last byte of the stream's middle token flipped: in the 24- and
    32-bit formats that is the token's next byte."""

    def compress(self, data, la, sb, stats):
        s = bytearray(self.system.compress(data, la, sb, stats))
        if len(s) > 4:
            width = (((sb - 1).bit_length() + (la - 1).bit_length() + 8)
                     + 7) // 8
            t = (len(s) - 4) // width
            s[4 + (t // 2 + 1) * width - 1] ^= 0x5A
        return bytes(s)


class HalfInput(_Wrap):
    def compress(self, data, la, sb, stats):
        return self.system.compress(data[:len(data) // 2], la, sb, stats)


class OutputAltered(_Wrap):
    def decompress(self, stream):
        out = bytearray(self.system.decompress(stream))
        if out:
            out[len(out) // 2] ^= 0xFF
        return bytes(out)


CONTROLS = {"half-window": HalfWindow}
FAULTS = {"token-altered": TokenAltered, "half-input": HalfInput,
          "output-altered": OutputAltered}
