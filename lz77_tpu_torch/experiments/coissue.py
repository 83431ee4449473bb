"""Can the sweep's slab work and the walk's dependent scalar chain overlap
inside one kernel?  The co-issue probe, on one CUDA card.

The JAX repository's ``experiments/coissue.py`` asks this of a TPU's vector
and scalar units under Mosaic.  On Hopper the same question decides whether
a warp-specialised merged sweep+walk kernel (K5) could approach
max(sweep, walk) instead of sweep + walk: does a latency-bound chain of
dependent loads in one warp hide behind slab work in the other warps of the
same SM?  It is measured with the experiment's calibrated proxies, each one
thread block on one SM (``csrc/coissue.cu``):

  V  vector-only: ``nv`` loop-carried :func:`vec_body` steps on an
     (8, 32, 128) int32 slab held in registers, a warp a slab (rolls +
     logical ops; :func:`vec_body_registers` follows the kernel's order).
  S  scalar-only: ``ns`` walk-like dependent steps on a (4096,) int32
     table seeded with a (2048,) one (load -> derive -> store -> advance).
  F  fused: ``nv`` iterations of one V body + ``k`` S steps, the two
     chains on different warps of one block (no barrier between them).
  Q  sequential: the V loop, then the S loop, in one kernel.

Verdict rule: t_F ~ max(t_V, t_S) means the chains overlap (build the
merged kernel); t_F ~ t_V + t_S means they do not.

Each wrapper (:func:`call_v`, :func:`call_s`, :func:`call_f`,
:func:`call_q`) returns what the experiment's ``_call_*`` returns; V, F and
Q also return the whole slab.  A CUDA tensor launches the kernel or
raises, a CPU tensor runs the plain version (:func:`kernel_v` and kin).
The TPU kernels start from uninitialised slab memory; these start from
``init``, zeros unless given (interpret mode's ``uninitialized_memory=
"zero"``).  From any uniform slab the rolls cancel and every element is
``init + nv``, so a check of the rolls needs a random ``init``.

Run on the card (it raises without one; the CPU runs only when asked)::

    python -m lz77_tpu_torch.experiments.coissue [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .. import _build
from .. import device as device_lib

SLAB = 8          # vector slab: (SLAB, RR, LANES) int32
RR = 32
LANES = 128
SCH = 2048        # scalar table: (2 * SCH,) int32, the seed in its first half
UNROLL = 8
# the experiment's sizes: every timed call does >= ~100 ms of device work
NV1, NV2 = 100_000, 200_000
NS1, NS2 = 4_000_000, 8_000_000

KEYS = ("vec_body_us", "scal_step_ns", "scal_k_steps_us",
        "k_scalar_steps_per_iter", "fused_iter_us", "seq_nests_iter_us",
        "sum_us", "max_us", "overlap_efficiency_fused",
        "overlap_efficiency_seq")


def make_seed(rng: np.random.Generator) -> np.ndarray:
    """The experiment's (SCH,) int32 seed: ``ln << 16 | r`` with walk-like
    jumps ``ln`` in [0, 8] (about five positions a step), ``r`` 16 bits."""
    ln = rng.integers(0, 9, SCH).astype(np.int32)
    return (ln << 16) | rng.integers(0, 65536, SCH).astype(np.int32)


# ---------------------------------------------------------------- plain ---

def vec_body(x: torch.Tensor) -> torch.Tensor:
    """One sweep-window-like step: ``(x ^ roll(x, 1, 2)) | (x & roll(x, 1,
    1)) + 1`` over the whole slab, int32 wrapping."""
    return ((x ^ torch.roll(x, 1, 2)) | (x & torch.roll(x, 1, 1))) + 1


def to_registers(slab: torch.Tensor) -> torch.Tensor:
    """(SLAB, RR, LANES) -> (SLAB, 32, RR, 4): warp w's thread t holds
    lanes 4t..4t+3 of every row of slab w, as in ``coissue_v_kernel``."""
    return slab.reshape(SLAB, RR, 32, LANES // 32).permute(0, 2, 1, 3) \
        .contiguous()


def from_registers(x: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`to_registers`."""
    return x.permute(0, 2, 1, 3).reshape(SLAB, RR, LANES)


def vec_body_registers(x: torch.Tensor) -> torch.Tensor:
    """:func:`vec_body` in ``coissue_v_kernel``'s order, for the tests, on
    the per-thread arrays of :func:`to_registers`: rows updated in place
    from 31 down to 0 (the row above still old; row 0 takes the old row 31,
    saved first), each row's lanes from 3 down to 0 (the left neighbour
    still old), lane 0 taking thread t - 1's old lane 3 (the shuffle, a
    roll over the thread axis)."""
    x = x.clone()
    last = x[:, :, RR - 1].clone()
    for r in range(RR - 1, -1, -1):
        w = torch.roll(x[:, :, r, -1], 1, 1)
        up = x[:, :, r - 1] if r else last
        for j in range(x.shape[3] - 1, -1, -1):
            a = x[:, :, r, j - 1] if j else w
            v = x[:, :, r, j]
            x[:, :, r, j] = ((v ^ a) | (v & up[..., j])) + 1
    return x


# words a wrong roll or a wrong in-place order would move: the slab's
# corners and the ends of a thread's four lanes (4t and 4t + 3) in the
# first, last and middle rows and threads
ONE_HOT = ((0, 0), (RR - 1, LANES - 1), (0, 4), (RR - 1, 3), (15, 64),
           (16, 63), (1, LANES - 4), (RR - 2, LANES - 1))


def one_hot_slab(row: int, lane: int) -> torch.Tensor:
    """A zero (SLAB, RR, LANES) int32 slab but for one word at (row, lane)
    of each slab, another word in each slab."""
    x = torch.zeros((SLAB, RR, LANES), dtype=torch.int32)
    words = np.arange(1, SLAB + 1, dtype=np.uint32) * np.uint32(0x9E3779B9)
    x[:, row, lane] = torch.from_numpy(words.view(np.int32))
    return x


def scal_steps(tab: torch.Tensor, t: int, p: int, k: int) -> tuple[int, int]:
    """``k`` walk-like dependent steps on ``tab``: load at ``p``, derive,
    store at ``(t + SCH) % (2 * SCH)``, advance.  ``>>`` on int32 is an
    arithmetic shift where the TPU kernel's is logical; the ``& 0xFF``
    keeps bits 16-23 either way."""
    for _ in range(k):
        w = tab[p]
        ln = (w >> 16) & 0xFF
        tab[(t + SCH) % (2 * SCH)] = w | (ln << 8)
        t += 1
        p = (p + int(ln) + 1) % SCH
    return t, p


def _table(seed: torch.Tensor) -> torch.Tensor:
    tab = torch.zeros(2 * SCH, dtype=torch.int32, device=seed.device)
    tab[:SCH] = seed
    return tab


def _t_plus_p(t: int, p: int, dev) -> torch.Tensor:
    v = (t + p + (1 << 31)) % (1 << 32) - (1 << 31)  # int32 wrap
    return torch.tensor([v], dtype=torch.int32, device=dev)


def kernel_v(init: torch.Tensor, nv: int) -> torch.Tensor:
    """Plain X-V: the slab after ``nv`` :func:`vec_body` steps."""
    x = init.clone()
    for _ in range(nv):
        x = vec_body(x)
    return x


def kernel_s(seed: torch.Tensor, ns: int, unroll: int) -> torch.Tensor:
    """Plain X-S: ``t + p`` after ``(ns // unroll) * unroll`` steps."""
    tab = _table(seed)
    t, p = scal_steps(tab, 0, 0, (ns // unroll) * unroll)
    return _t_plus_p(t, p, seed.device)


def kernel_f(seed: torch.Tensor, init: torch.Tensor, nv: int,
             k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain X-F: ``nv`` iterations of one body and ``k`` scalar steps ->
    (slab, t + p)."""
    tab = _table(seed)
    x, t, p = init.clone(), 0, 0
    for _ in range(nv):
        x = vec_body(x)
        t, p = scal_steps(tab, t, p, k)
    return x, _t_plus_p(t, p, seed.device)


def kernel_q(seed: torch.Tensor, init: torch.Tensor, nv: int, ns: int,
             unroll: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain X-Q: the vector loop, then the scalar loop -> (slab, t + p)."""
    return kernel_v(init, nv), kernel_s(seed, ns, unroll)


# -------------------------------------------------------------- wrappers ---

def _count(name: str, n: int) -> int:
    if not 0 <= n < (1 << 31):
        raise ValueError(f"{name} {n} outside [0, 2^31)")
    return n


def _steps(ns: int, unroll: int) -> int:
    if unroll < 1:
        raise ValueError(f"unroll {unroll} must be positive")
    return (_count("ns", ns) // unroll) * unroll


def _check_seed(seed: torch.Tensor) -> None:
    if seed.dtype != torch.int32 or tuple(seed.shape) != (SCH,) \
            or not seed.is_contiguous():
        raise ValueError(f"seed must be a contiguous ({SCH},) int32 tensor")


def _slab(init: torch.Tensor | None, dev: torch.device) -> torch.Tensor:
    """``init``, checked, or the zero slab on ``dev``."""
    if init is None:
        return torch.zeros((SLAB, RR, LANES), dtype=torch.int32, device=dev)
    if init.dtype != torch.int32 or tuple(init.shape) != (SLAB, RR, LANES) \
            or not init.is_contiguous() or init.device.type != dev.type:
        raise ValueError(f"init must be a contiguous ({SLAB}, {RR}, {LANES}) "
                         f"int32 tensor on {dev.type}")
    return init


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def call_v(nv: int, init: torch.Tensor | None = None,
           device: str | torch.device | None = None):
    """X-V -> (slab 0 as (1, 32, 128), the whole (8, 32, 128) slab).

    The slab starts from ``init`` or, by default, zeros on ``device``
    (the card unless told otherwise).  ``call_v.launches`` counts
    launches."""
    dev = init.device if init is not None and device is None \
        else device_lib.resolve(device)
    slab = _slab(init, dev)
    _count("nv", nv)
    if not slab.is_cuda:
        out = kernel_v(slab, nv)
        return out[:1], out
    lib = _build.kernels()
    out = torch.empty_like(slab)
    with torch.cuda.device(slab.device):
        err = lib.lz77_coissue_v(slab.data_ptr(), out.data_ptr(), nv,
                                 _stream())
    _build.check(err, "coissue_v_kernel")
    call_v.launches += 1
    return out[:1], out


def call_s(seed: torch.Tensor, ns: int, unroll: int) -> torch.Tensor:
    """X-S -> (1,) int32 ``t + p`` after ``(ns // unroll) * unroll`` steps.
    ``call_s.launches`` counts launches."""
    _check_seed(seed)
    steps = _steps(ns, unroll)
    if not seed.is_cuda:
        return kernel_s(seed, ns, unroll)
    lib = _build.kernels()
    out = torch.empty(1, dtype=torch.int32, device=seed.device)
    with torch.cuda.device(seed.device):
        err = lib.lz77_coissue_s(seed.data_ptr(), out.data_ptr(), steps,
                                 _stream())
    _build.check(err, "coissue_s_kernel")
    call_s.launches += 1
    return out


def _call_pair(fn, what: str, seed, init, nv: int, steps: int):
    slab = _slab(init, seed.device)
    lib = _build.kernels()
    out = torch.empty_like(slab)
    out2 = torch.empty(1, dtype=torch.int32, device=seed.device)
    with torch.cuda.device(seed.device):
        err = getattr(lib, fn)(seed.data_ptr(), slab.data_ptr(),
                               out.data_ptr(), out2.data_ptr(), nv, steps,
                               _stream())
    _build.check(err, what)
    return out[:1], out2, out


def call_f(seed: torch.Tensor, nv: int, k: int,
           init: torch.Tensor | None = None):
    """X-F -> (slab 0, (1,) int32 ``t + p`` after ``nv * k`` steps, the
    whole slab).  ``call_f.launches`` counts launches."""
    _check_seed(seed)
    _count("nv", nv)
    if not 0 <= k < (1 << 31):
        raise ValueError(f"k {k} outside [0, 2^31)")
    if not seed.is_cuda:
        slab, tp = kernel_f(seed, _slab(init, seed.device), nv, k)
        return slab[:1], tp, slab
    res = _call_pair("lz77_coissue_f", "coissue_f_kernel", seed, init, nv,
                     nv * k)
    call_f.launches += 1
    return res


def call_q(seed: torch.Tensor, nv: int, ns: int, unroll: int,
           init: torch.Tensor | None = None):
    """X-Q -> (slab 0, (1,) int32 ``t + p``, the whole slab): the vector
    loop, then ``(ns // unroll) * unroll`` scalar steps.
    ``call_q.launches`` counts launches."""
    _check_seed(seed)
    _count("nv", nv)
    steps = _steps(ns, unroll)
    if not seed.is_cuda:
        slab, tp = kernel_q(seed, _slab(init, seed.device), nv, ns, unroll)
        return slab[:1], tp, slab
    res = _call_pair("lz77_coissue_q", "coissue_q_kernel", seed, init, nv,
                     steps)
    call_q.launches += 1
    return res


call_v.launches = call_s.launches = call_f.launches = call_q.launches = 0


# ---------------------------------------------------------------- probe ---

def time_call(fn, dev: torch.device) -> float:
    """Min-of-5 seconds of ``fn()`` after one warm-up: CUDA events around
    the device's work on a card, the host clock on the CPU."""
    fn()
    best = float("inf")
    for _ in range(5):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            best = min(best, a.elapsed_time(b) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
    return best


def slope(f_of_n, n1, n2) -> float:
    """Per-unit time via two sizes (fixed launch costs cancel)."""
    return (f_of_n(n2) - f_of_n(n1)) / (n2 - n1)


def probe(device: str | torch.device | None = None) -> dict:
    """The experiment's measurement -> {key: value} (``KEYS``, unrounded),
    each slope taken over ``NV1, NV2`` or ``NS1, NS2``."""
    dev = device_lib.resolve(device)
    seed = torch.from_numpy(make_seed(np.random.default_rng(0))).to(dev)

    v_per = slope(lambda n: time_call(lambda: call_v(n, device=dev), dev),
                  NV1, NV2)
    s_per = slope(lambda n: time_call(lambda: call_s(seed, n, UNROLL), dev),
                  NS1, NS2)  # seconds per scalar step
    # k scalar steps per fused iteration ~ one vector body's worth
    k = max(UNROLL, int(round(v_per / s_per / UNROLL)) * UNROLL)
    f_per = slope(lambda n: time_call(lambda: call_f(seed, n, k), dev),
                  NV1, NV2)
    q_per = slope(lambda n: time_call(
        lambda: call_q(seed, n, n * k, UNROLL), dev), NV1, NV2)
    s_i = s_per * k  # k scalar steps standalone
    return {
        "vec_body_us": v_per * 1e6,
        "scal_step_ns": s_per * 1e9,
        "scal_k_steps_us": s_i * 1e6,
        "k_scalar_steps_per_iter": k,
        "fused_iter_us": f_per * 1e6,
        "seq_nests_iter_us": q_per * 1e6,
        "sum_us": (v_per + s_i) * 1e6,
        "max_us": max(v_per, s_i) * 1e6,
        "overlap_efficiency_fused": (v_per + s_i - f_per) / min(v_per, s_i),
        "overlap_efficiency_seq": (v_per + s_i - q_per) / min(v_per, s_i),
    }


def result_line(r: dict) -> str:
    """The experiment's one JSON line: floats rounded to 4 places."""
    return json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                       for k, v in r.items()})


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m lz77_tpu_torch.experiments.coissue",
        description="Co-issue probe: do a slab chain and a dependent "
                    "scalar chain overlap inside one kernel?")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="default: the CUDA card (raises without one); the "
                         "CPU runs the plain versions, at these sizes for "
                         "hours")
    args = ap.parse_args(argv)
    print(result_line(probe(args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
