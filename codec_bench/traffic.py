"""The one traffic generator: a mix's parameters (``traffic/<mix>.json``)
and the run's seed -> the deck of calls the window cycles through.

A deck item is one call: ``op`` ("compress" or "decompress") of the bytes
``pool[file][offset:offset + size]``.  Keys of a mix:

* ``items``: "files" (each file of the configuration whole, in the
  configuration's order, starting at a file drawn from the seed) or
  "blocks" (``deck`` blocks cut from the pool's files at seeded offsets).
* ``ops``: {op: share}.  Each op gets ``round(share * len(deck))`` items.
* ``block_bytes``: [least, most] block size for "blocks".  The sizes are
  the ``deck`` quantiles of the log-uniform distribution over that range.
  Ops and files (in proportion to the files' sizes) are spread evenly over
  the sizes in a fixed pattern, so every seed has the same set of (size,
  file, op); the seed draws each block's offset and the deck's order.
* ``window_ends``: "round" (the window runs whole passes over the deck
  until ``--seconds`` has passed) or "call" (whole calls until it has).
* ``keep_share``: the share of calls, beyond the first of each item, whose
  answer is kept and compared (drawn from the seed); every answer of a
  decompress call is kept.
* ``token_samples``: the tokens drawn from the seed and held to the
  reference's longest match.
"""

from __future__ import annotations

import dataclasses

import numpy as np

OPS = ("compress", "decompress")


@dataclasses.dataclass(frozen=True)
class Item:
    op: str
    file: int
    offset: int
    size: int
    name: str


def _spread(counts: list[int]) -> list[int]:
    """Indices ``k`` repeated ``counts[k]`` times, each spread evenly over
    the sequence (a fixed pattern: no seed)."""
    keys = [((j + 0.5) / c, k) for k, c in enumerate(counts)
            for j in range(c)]
    return [k for _, k in sorted(keys)]


def _counts(weights, n: int) -> list[int]:
    """``n`` split by ``weights``, largest remainders first."""
    w = np.asarray(weights, np.float64) / sum(weights)
    c = np.floor(w * n).astype(np.int64)
    for k in np.argsort(-(w * n - c), kind="stable")[:n - int(c.sum())]:
        c[k] += 1
    return c.tolist()


def deck(mix: dict, files: list[dict], sizes: list[int], seed: int
         ) -> list[Item]:
    """The calls of one pass, in order.  ``files`` are the configuration's
    entries and ``sizes`` the pool's actual file sizes."""
    rng = np.random.default_rng([seed, 0x7AFF1C])
    names = list(mix["ops"])
    unknown = set(names) - set(OPS)
    if unknown:
        raise ValueError(f"unknown ops {sorted(unknown)}")
    if mix["items"] == "files":
        first = int(rng.integers(len(files)))
        order = [(first + i) % len(files) for i in range(len(files))]
        ops = _spread(_counts([mix["ops"][o] for o in names], len(order)))
        return [Item(names[o], f, 0, sizes[f], files[f]["name"])
                for o, f in zip(ops, order)]
    if mix["items"] != "blocks":
        raise ValueError(f"unknown items {mix['items']!r}")
    n = int(mix["deck"])
    lo, hi = mix["block_bytes"]
    q = (np.arange(n) + 0.5) / n
    block = np.exp(np.log(lo) + q * (np.log(hi) - np.log(lo)))
    block = np.minimum(block.round().astype(np.int64), min(sizes))
    ops = _spread(_counts([mix["ops"][o] for o in names], n))
    src = _spread(_counts(sizes, n))
    out = []
    for i in rng.permutation(n):
        f, b = src[i], int(block[i])
        off = int(rng.integers(0, sizes[f] - b + 1))
        out.append(Item(names[ops[i]], f, off, b,
                        f"{files[f]['name']}@{off}+{b}"))
    return out
