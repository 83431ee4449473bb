"""State carried across from the JAX package, as plain Python and numpy.

The codec has no weights.  What the two packages must agree on is the
format parameters, the per-batch state — the (G, B) batch inputs, the
match tables (full and compact), the LOX words, the token fields, the
decoder's carried tail and the scan parser's entry->exit map — and
the checkpoint manifest of a file encode, which either package may write
and the other resume.  These functions turn
the JAX package's values — handed over as Python ints and numpy arrays,
never as jax arrays — into this package's tensors, with its dtypes, on the
device asked for, and :func:`to_numpy` takes a result back.  The tests push the same numpy inputs through both
packages with them.
"""

from __future__ import annotations

import numpy as np
import torch

from . import device as device_lib
from . import spec
from .ops import decode_walk, parse_walk
from .utils import manifest as manifest_lib


def _tensor(a, np_dtype, dev) -> torch.Tensor:
    # np.array copies: values handed over from jax are read-only buffers
    return torch.from_numpy(np.array(a, dtype=np_dtype)).to(dev)


def params_from_reference(la: int, sb: int) -> spec.Params:
    """The JAX package's (la, sb) -> this package's validated ``Params``."""
    return spec.Params(la=int(la), sb=int(sb))


def batch_from_numpy(gb, gh, gr, ga, gv, valid_total, entry, device=None):
    """The batch tuple of ``codec._batch_inputs`` plus the two scalars ->
    the arguments of ``fused.encode_batch_walk``.

    Returns (blocks, halos, rights, avails, valid_exts, valid_total, entry0):
    uint8 (G, B) / (G, H) / (G, R), int32 (G,) twice, a Python int, and a
    (1,) int32 tensor.
    """
    dev = device_lib.resolve(device)
    return (
        _tensor(gb, np.uint8, dev), _tensor(gh, np.uint8, dev),
        _tensor(gr, np.uint8, dev), _tensor(ga, np.int32, dev),
        _tensor(gv, np.int32, dev), int(valid_total),
        _tensor(np.asarray(entry).reshape(1), np.int32, dev),
    )


def tables_from_numpy(L, O, device=None):
    """Match tables (any integer dtype, any shape) -> int32 tensors (L, O)."""
    dev = device_lib.resolve(device)
    return _tensor(L, np.int32, dev), _tensor(O, np.int32, dev)


def lox_from_numpy(L, O, x, tail, la: int, device=None) -> torch.Tensor:
    """Flat match tables, span bytes and tail bytes -> K2's LOX words."""
    dev = device_lib.resolve(device)
    Lt, Ot = tables_from_numpy(np.asarray(L).reshape(-1),
                               np.asarray(O).reshape(-1), dev)
    return parse_walk.build_lox(
        Lt, Ot, _tensor(x, np.uint8, dev).reshape(-1),
        _tensor(tail, np.uint8, dev), la,
    )


def tokens_from_numpy(off, ln, nxt, device=None) -> torch.Tensor:
    """Token fields -> K3's (T,) int32 decode words on the device."""
    dev = device_lib.resolve(device)
    return torch.from_numpy(
        decode_walk.pack_token_words(
            np.asarray(off), np.asarray(ln), np.asarray(nxt)
        )
    ).to(dev)


def token_fields_from_numpy(off, ln, nxt, count, prev_tail=None, device=None):
    """Token-field arrays as the JAX package's block encoder and chunk
    decoder pass them -> (off, ln, nxt, count[, prev_tail]): three (T,)
    int32 tensors, a 0-d int32 count and, where given, the (H,) uint8 tail
    of already-decoded bytes."""
    dev = device_lib.resolve(device)
    out = tuple(_tensor(a, np.int32, dev) for a in (off, ln, nxt)) + (
        _tensor(count, np.int32, dev).reshape(()),
    )
    if prev_tail is not None:
        out += (_tensor(prev_tail, np.uint8, dev),)
    return out


def map_from_numpy(bmap, l_head, o_head, device=None):
    """The ``with_map`` outputs of the scan parser's batch step — the (la,)
    entry->exit map and the head match tables — as int32 tensors."""
    dev = device_lib.resolve(device)
    return tuple(_tensor(a, np.int32, dev) for a in (bmap, l_head, o_head))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor of the port -> the numpy array the JAX package's values are
    compared with."""
    return t.detach().cpu().numpy()


def compact_from_numpy(packed_L, O16, device=None):
    """The compact match outputs of the JAX package's
    ``match_blocks_compact`` (nibble-packed or bytewise uint8 lengths, uint16
    offsets) -> this package's pair: uint8 lengths as they are, offsets as
    an int16 tensor carrying the uint16 bit pattern (what
    ``models.encoder.gather_offsets`` reads)."""
    dev = device_lib.resolve(device)
    o16 = np.array(O16, dtype=np.uint16).view(np.int16)
    return _tensor(packed_L, np.uint8, dev), torch.from_numpy(o16).to(dev)


def manifest_from_dict(d: dict) -> manifest_lib.Manifest:
    """A manifest as the JAX package's ``utils.manifest`` writes it (the
    parsed JSON) -> this package's ``Manifest``."""
    return manifest_lib.Manifest.from_dict(d)


def manifest_to_dict(m: manifest_lib.Manifest) -> dict:
    """This package's ``Manifest`` -> the dict both packages store as JSON."""
    return m.to_dict()
