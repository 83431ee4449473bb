"""The comparison that decides ``correct``.

Every number below is a count of differences from the plain reference
(``reference.py``), and every limit is 0: the codec is exact, so one byte
or one token off is a wrong answer.

* ``failed_calls``: window calls that raised.
* ``bad_streams``: judged streams whose header is not the configuration's
  (la, sb), whose last byte carries more than zero padding, or that hold a
  token no encoder of the format may emit.
* ``decode_diff_bytes``: over the judged streams, bytes where the
  reference's decode differs from the input, plus any difference in length.
* ``token_diff``: of ``token_samples`` tokens drawn from the seed across the
  judged streams, those whose (length, offset) is not the reference's
  longest match at the token's position (nearest offset on ties).
* ``repeat_diff``: window answers that differ from the judged answer of
  the same input: every compress call by its length, the kept ones by every
  byte.
* ``output_diff_bytes``: bytes by which the window's decompress answers
  differ from their inputs, plus any difference in length.

The judged streams are the first window answer of each compress item and
the set-up stream of each decompress item that the window decoded (the
program made those too).
"""

from __future__ import annotations

import numpy as np
import torch

from . import reference as ref

LIMITS = {"failed_calls": 0, "bad_streams": 0, "decode_diff_bytes": 0,
          "token_diff": 0, "repeat_diff": 0, "output_diff_bytes": 0}


def _bytes_diff(a: bytes, b: bytes) -> int:
    if a == b:
        return 0
    n = min(len(a), len(b))
    x = np.frombuffer(a, np.uint8, n)
    y = np.frombuffer(b, np.uint8, n)
    return int((x != y).sum()) + abs(len(a) - len(b))


def _token_count(stream: bytes, la: int, sb: int) -> int:
    width = ref.bitof(sb) + ref.bitof(la) + 8
    return max(0, len(stream) - ref.HEADER_BYTES) * 8 // width


def judged(run) -> list[tuple[int, bytes]]:
    """(item, stream) of every stream the reference judges."""
    read = {c.item for c in run.calls if c.op == "decompress"}
    out = sorted(run.first.items())
    out += sorted((k, s) for k, s in run.streams.items() if k in read)
    return out


def judge(run, device) -> tuple[dict, dict]:
    """Each number of the module's docstring with its limit, ``{name:
    {"value": v, "limit": l}}``, and how much was judged."""
    la, sb = run.config["la"], run.config["sb"]
    nums = dict.fromkeys(LIMITS, 0)
    nums["failed_calls"] = sum(c.error is not None for c in run.calls)

    for c in run.calls:  # every compress answer, by its length
        if c.op == "compress" and c.error is None \
                and c.nout != len(run.first[c.item]):
            nums["repeat_diff"] += 1
    for k, s in run.repeats:  # the kept ones, by every byte
        if s != run.first[k]:
            nums["repeat_diff"] += 1
    for k, out in run.outputs:
        nums["output_diff_bytes"] += _bytes_diff(out, run.inputs[k])

    streams = judged(run)
    counts = np.array([_token_count(s, la, sb) for _, s in streams],
                      np.int64)
    total = int(counts.sum())
    want = int(run.mix.get("token_samples", 0))
    rng = np.random.default_rng([run.seed, 0x5A3E])
    picks = np.sort(rng.choice(total, size=min(want, total), replace=False)
                    ) if total else np.zeros(0, np.int64)
    first_tok = np.concatenate([[0], np.cumsum(counts)])
    for j, (k, stream) in enumerate(streams):
        x = torch.from_numpy(
            np.frombuffer(run.inputs[k], np.uint8).copy()).to(device)
        try:
            tok = ref.parse(stream, device)
        except ValueError:
            nums["bad_streams"] += 1
            nums["decode_diff_bytes"] += x.shape[0]
            continue
        bad = (tok.la, tok.sb) != (la, sb) or tok.bad_tail \
            or bool(ref.invalid(tok).any())
        nums["bad_streams"] += int(bad)
        out = ref.decode(tok)
        m = min(out.shape[0], x.shape[0])
        nums["decode_diff_bytes"] += int((out[:m] != x[:m]).sum()) \
            + abs(out.shape[0] - x.shape[0])
        del out
        mine = picks[(picks >= first_tok[j]) & (picks < first_tok[j + 1])] \
            - first_tok[j]
        if mine.shape[0]:
            idx = torch.from_numpy(mine).to(device)
            pos = ref.starts(tok)[idx]
            inside = pos < x.shape[0]
            ln, off = ref.longest_match(x, pos[inside], la, sb)
            nums["token_diff"] += int((~inside).sum()) + int(
                ((ln != tok.ln[idx][inside])
                 | (off != tok.off[idx][inside])).sum())
        del tok, x
    nums["tokens_sampled"] = int(picks.shape[0])
    nums["judged_streams"] = len(streams)
    out = {k: {"value": v, "limit": LIMITS[k]} for k, v in nums.items()
           if k in LIMITS}
    return out, {k: nums[k] for k in ("tokens_sampled", "judged_streams")}


def correct(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
