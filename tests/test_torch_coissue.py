"""Port co-issue probe (lz77_tpu_torch.experiments.coissue) against the
experiment's TPU kernels.

The JAX kernels run once, interpreted, in a fresh process: test-local
``pl.pallas_call``s over ``experiments/coissue.py``'s own kernel bodies,
with the same specs as its ``_call_*`` and uninitialised memory filled with
zeros (the port's default slab).  The same numpy inputs, made from a seed,
go through the port's wrappers on the CPU, so through the plain versions.
Tolerance 0: everything is int32.
"""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lz77_tpu_torch.experiments import coissue

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_RUNNER = r"""
import functools, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu
from experiments import coissue as xc

zero = pltpu.InterpretParams(uninitialized_memory="zero")
slab0 = jax.ShapeDtypeStruct((1, xc.RR, xc.LANES), jnp.int32)
one = jax.ShapeDtypeStruct((1,), jnp.int32)
vmem = pl.BlockSpec(memory_space=pltpu.VMEM)
smem = pl.BlockSpec(memory_space=pltpu.SMEM)
v_scr = pltpu.VMEM((xc.SLAB, xc.RR, xc.LANES), jnp.int32)
s_scr = pltpu.SMEM((2 * xc.SCH,), jnp.int32)
inp = np.load(sys.argv[1])
seed, slab = jnp.asarray(inp["seed"]), jnp.asarray(inp["slab"])
nv_v, ns_s, nv_f, k_f, nv_q, ns_q, nv_r = (int(a) for a in sys.argv[3:])

v = pl.pallas_call(functools.partial(xc._kernel_v, nv=nv_v),
                   out_shape=slab0, out_specs=vmem, scratch_shapes=[v_scr],
                   interpret=zero)()
s = pl.pallas_call(functools.partial(xc._kernel_s, ns=ns_s, unroll=8),
                   out_shape=one, in_specs=[smem], out_specs=smem,
                   scratch_shapes=[s_scr], interpret=zero)(seed)
f = pl.pallas_call(functools.partial(xc._kernel_f, nv=nv_f, k=k_f),
                   out_shape=[slab0, one], in_specs=[smem],
                   out_specs=[vmem, smem], scratch_shapes=[v_scr, s_scr],
                   interpret=zero)(seed)
q = pl.pallas_call(functools.partial(xc._kernel_q, nv=nv_q, ns=ns_q,
                                     unroll=8),
                   out_shape=[slab0, one], in_specs=[smem],
                   out_specs=[vmem, smem], scratch_shapes=[v_scr, s_scr],
                   interpret=zero)(seed)

def loaded(x_ref, o_ref, scr):  # _vec_body on a slab loaded first
    scr[...] = x_ref[...]
    for _ in range(nv_r):
        xc._vec_body(scr)
    o_ref[...] = scr[...]

r = pl.pallas_call(loaded, out_shape=jax.ShapeDtypeStruct(slab.shape,
                                                          jnp.int32),
                   in_specs=[vmem], out_specs=vmem, scratch_shapes=[v_scr],
                   interpret=zero)(slab)
np.savez(sys.argv[2], v=v, s=s, f0=f[0], f1=f[1], q0=q[0], q1=q[1], r=r)
"""

# (nv_v, ns_s, nv_f, k_f, nv_q, ns_q, nv_r): S runs past the table's wrap
# (2048 steps), where the chain starts to load its own stores
SIZES = dict(nv_v=3, ns_s=4104, nv_f=4, k_f=8, nv_q=4, ns_q=32, nv_r=3)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0xC015)
    seed = coissue.make_seed(rng)
    slab = rng.integers(-(1 << 31), 1 << 31, (coissue.SLAB, coissue.RR,
                                                coissue.LANES),
                        dtype=np.int64).astype(np.int32)
    return seed, slab


@pytest.fixture(scope="module")
def jax_runs(inputs, tmp_path_factory):
    """The experiment's kernels, interpreted once in a fresh process."""
    d = tmp_path_factory.mktemp("coissue")
    seed, slab = inputs
    np.savez(d / "in.npz", seed=seed, slab=slab)
    r = subprocess.run(
        [sys.executable, "-c", _RUNNER, str(d / "in.npz"), str(d / "out.npz"),
         *(str(v) for v in SIZES.values())],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu"),
    )
    assert r.returncode == 0, r.stderr[-2000:]
    return dict(np.load(d / "out.npz"))


def _seed(inputs):
    return torch.from_numpy(inputs[0])


def test_v_matches_the_tpu_kernel_zero_filled(jax_runs):
    out, slab = coissue.call_v(SIZES["nv_v"], device="cpu")
    assert out.shape == (1, coissue.RR, coissue.LANES)
    assert slab.shape == (coissue.SLAB, coissue.RR, coissue.LANES)
    np.testing.assert_array_equal(out.numpy(), jax_runs["v"])


def test_s_matches_the_tpu_kernel_past_the_wrap(inputs, jax_runs):
    assert SIZES["ns_s"] > 2 * coissue.SCH
    out = coissue.call_s(_seed(inputs), SIZES["ns_s"], 8)
    assert out.dtype == torch.int32 and out.shape == (1,)
    np.testing.assert_array_equal(out.numpy(), jax_runs["s"])


def test_f_matches_the_tpu_kernel(inputs, jax_runs):
    out, tp, _ = coissue.call_f(_seed(inputs), SIZES["nv_f"], SIZES["k_f"])
    np.testing.assert_array_equal(out.numpy(), jax_runs["f0"])
    np.testing.assert_array_equal(tp.numpy(), jax_runs["f1"])


def test_q_matches_the_tpu_kernel(inputs, jax_runs):
    out, tp, _ = coissue.call_q(_seed(inputs), SIZES["nv_q"], SIZES["ns_q"],
                                8)
    np.testing.assert_array_equal(out.numpy(), jax_runs["q0"])
    np.testing.assert_array_equal(tp.numpy(), jax_runs["q1"])


def test_vec_body_matches_the_tpu_body_on_a_random_slab(inputs, jax_runs):
    """A uniform slab hides the rolls (x ^ x = 0, x & x = x); a random one
    does not."""
    init = torch.from_numpy(inputs[1])
    _, slab = coissue.call_v(SIZES["nv_r"], init=init)
    np.testing.assert_array_equal(slab.numpy(), jax_runs["r"])
    assert len(np.unique(jax_runs["r"])) > 1000


@pytest.mark.parametrize("nv", [1, 2, 5])
def test_vec_body_matches_numpy(inputs, nv):
    """The plain body against numpy's rolls, int32 wrapping, all 8 slabs."""
    x = inputs[1].copy()
    with np.errstate(over="ignore"):
        for _ in range(nv):
            x = ((x ^ np.roll(x, 1, 2)) | (x & np.roll(x, 1, 1))) \
                + np.int32(1)
    _, slab = coissue.call_v(nv, init=torch.from_numpy(inputs[1]))
    np.testing.assert_array_equal(slab.numpy(), x)


@pytest.mark.parametrize("ns,unroll", [(0, 8), (7, 8), (2048, 8),
                                       (6001, 8), (6001, 3)])
def test_scalar_chain_matches_a_python_loop(inputs, ns, unroll):
    """The plain chain against plain Python ints, ``t + p`` with
    ``t = (ns // unroll) * unroll``."""
    tab = [int(v) for v in inputs[0]] + [0] * coissue.SCH
    t = p = 0
    for _ in range((ns // unroll) * unroll):
        w = tab[p]
        ln = (w >> 16) & 0xFF
        tab[(t + 2048) % 4096] = w | (ln << 8)
        t, p = t + 1, (p + ln + 1) % 2048
    assert int(coissue.call_s(_seed(inputs), ns, unroll)) == t + p


def test_zero_fill_is_the_default(inputs):
    """The TPU kernels read uninitialised VMEM; the port starts from zeros,
    so every element is nv."""
    for nv in (0, 1, 6):
        out, slab = coissue.call_v(nv, device="cpu")
        assert (slab == nv).all() and (out == nv).all()
    _, _, slab = coissue.call_f(_seed(inputs), 3, 8)
    assert (slab == 3).all()
    _, _, slab = coissue.call_q(_seed(inputs), 4, 8, 8)
    assert (slab == 4).all()


def test_f_and_q_equal_v_and_s(inputs):
    """F's and Q's two outputs are V's and S's: the chains are independent."""
    seed, init = _seed(inputs), torch.from_numpy(inputs[1])
    _, tp_f, slab_f = coissue.call_f(seed, 5, 16, init=init)
    _, tp_q, slab_q = coissue.call_q(seed, 5, 80, 8, init=init)
    _, slab_v = coissue.call_v(5, init=init)
    assert torch.equal(slab_f, slab_v) and torch.equal(slab_q, slab_v)
    assert torch.equal(tp_f, coissue.call_s(seed, 80, 8))
    assert torch.equal(tp_q, tp_f)


def test_cpu_calls_count_no_launch(inputs):
    names = ("call_v", "call_s", "call_f", "call_q")
    for n in names:
        setattr(getattr(coissue, n), "launches", 0)
    coissue.call_v(2, device="cpu")
    coissue.call_s(_seed(inputs), 16, 8)
    coissue.call_f(_seed(inputs), 2, 8)
    coissue.call_q(_seed(inputs), 2, 16, 8)
    assert [getattr(coissue, n).launches for n in names] == [0, 0, 0, 0]


def test_cuda_call_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for call in (lambda: coissue.call_v(1),
                 lambda: coissue.call_v(1, device="cuda"),
                 lambda: coissue.probe(),
                 lambda: coissue.main([])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


@pytest.mark.parametrize("call,match", [
    (lambda s, i: coissue.call_s(s[:-1], 8, 8), "seed"),
    (lambda s, i: coissue.call_s(s.to(torch.int64), 8, 8), "seed"),
    (lambda s, i: coissue.call_s(s, 8, 0), "unroll"),
    (lambda s, i: coissue.call_s(s, -1, 8), "ns"),
    (lambda s, i: coissue.call_v(-1, device="cpu"), "nv"),
    (lambda s, i: coissue.call_v(1, init=i[:1]), "init"),
    (lambda s, i: coissue.call_f(s, 1, -1, init=i), "k"),
    (lambda s, i: coissue.call_q(s, 1, 8, 8, init=i.to(torch.int64)),
     "init"),
])
def test_wrappers_reject_what_the_kernels_do_not_take(inputs, call, match):
    with pytest.raises(ValueError, match=match):
        call(_seed(inputs), torch.from_numpy(inputs[1]))


def _experiment_keys():
    """The keys of the result dict in the experiment's ``main``."""
    with open(os.path.join(REPO, "experiments", "coissue.py")) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    d = next(n.value for n in ast.walk(main) if isinstance(n, ast.Assign)
             and isinstance(n.value, ast.Dict)
             and [t.id for t in n.targets] == ["r"])
    return [k.value for k in d.keys]


def test_probe_prints_the_experiments_keys(capsys, monkeypatch):
    """``main``'s line has the experiment's keys, in its order (on the
    CPU at toy sizes: the numbers are host times and mean nothing)."""
    for name, v in (("NV1", 1), ("NV2", 2), ("NS1", 8), ("NS2", 16)):
        monkeypatch.setattr(coissue, name, v)
    r = coissue.probe("cpu")
    assert list(r) == list(coissue.KEYS) == _experiment_keys()
    assert r["k_scalar_steps_per_iter"] % coissue.UNROLL == 0
    monkeypatch.setattr(coissue, "probe",
                        lambda device=None: dict(r, vec_body_us=1.23456))
    assert coissue.main(["--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line) == _experiment_keys()
    assert line["vec_body_us"] == 1.2346


# ---------------------------------------------- the kernels' decomposition
# coissue_v_kernel holds slab w in warp w's registers, thread t its lanes
# 4t..4t+3 of all 32 rows; vec_body_registers follows its order (rows 31
# down to 0 in place with the old row 31 saved, lanes 3 down to 0, lane 0
# from thread t - 1 by a shuffle).  Tolerance 0.

def _numpy_bodies(x: np.ndarray, nv: int) -> np.ndarray:
    with np.errstate(over="ignore"):
        for _ in range(nv):
            x = ((x ^ np.roll(x, 1, 2)) | (x & np.roll(x, 1, 1))) + np.int32(1)
    return x


def _register_bodies(slab: torch.Tensor, nvs):
    """{nv: slab after nv bodies in the kernel's order} for each nv."""
    x, out = coissue.to_registers(slab), {}
    for i in range(1, max(nvs) + 1):
        x = coissue.vec_body_registers(x)
        if i in nvs:
            out[i] = coissue.from_registers(x)
    return out


def test_register_layout_is_the_kernels(inputs):
    slab = torch.from_numpy(inputs[1])
    x = coissue.to_registers(slab)
    assert x.shape == (coissue.SLAB, 32, coissue.RR, 4)
    for w, t, r in ((0, 0, 0), (3, 17, 9), (7, 31, 31)):
        assert torch.equal(x[w, t, r], slab[w, r, 4 * t:4 * t + 4])
    assert torch.equal(coissue.from_registers(x), slab)


def test_register_body_matches_the_tpu_body(inputs, jax_runs):
    nv = SIZES["nv_r"]
    got = _register_bodies(torch.from_numpy(inputs[1]), {nv})[nv]
    np.testing.assert_array_equal(got.numpy(), jax_runs["r"])


@pytest.mark.parametrize("nv", [1, 2, 7, 33])
def test_register_body_matches_numpy_and_vec_body(inputs, nv):
    """From a random slab; 33 bodies wrap the rows and the shuffle."""
    slab = torch.from_numpy(inputs[1])
    got = _register_bodies(slab, {nv})[nv]
    np.testing.assert_array_equal(got.numpy(), _numpy_bodies(inputs[1], nv))
    assert torch.equal(got, coissue.kernel_v(slab, nv))


@pytest.mark.parametrize("row,lane", coissue.ONE_HOT)
def test_register_body_on_one_hot_slabs(row, lane):
    """One word in each slab, at the corners or at the ends of a thread's
    four lanes: a wrong roll, a wrong in-place order or a wrong shuffle
    moves it (the row roll shows from the second body on)."""
    slab = coissue.one_hot_slab(row, lane)
    assert int((slab != 0).sum()) == coissue.SLAB
    nvs = (1, 2, 7, 33)
    got = _register_bodies(slab, set(nvs))
    for nv in nvs:
        want = _numpy_bodies(slab.numpy(), nv)
        np.testing.assert_array_equal(got[nv].numpy(), want)
        assert torch.equal(got[nv], coissue.kernel_v(slab, nv))


@pytest.mark.parametrize("w", [0, 5])
def test_slabs_never_mix(inputs, w):
    """What one warp a slab rests on: the rolls stay inside a slab, so a
    change to slab w changes slab w alone, after any number of bodies."""
    slab = torch.from_numpy(inputs[1])
    other = slab.clone()
    other[w, 31, 127] ^= 1
    a = _register_bodies(slab, {33})[33]
    b = _register_bodies(other, {33})[33]
    changed = [s for s in range(coissue.SLAB) if not torch.equal(a[s], b[s])]
    assert changed == [w]


def test_ptxas_report_is_parsed():
    """The probe's records read registers, spills and static shared
    memory from the build's ptxas report, a called function's too."""
    from lz77_tpu_torch import _build
    text = (
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116coissue"
        "_q_kernelEPKjS1_PjS2_ix' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_116coissue"
        "_q_kernelEPKjS1_PjS2_ix\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 164 registers, used 2 barriers, 16384 bytes "
        "smem, 400 bytes cmem[0]\n"
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_18vec_loop"
        "EPKjPjii\n"
        "    8 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116coissue"
        "_v_kernelEPKjPji' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_116coissue"
        "_v_kernelEPKjPji\n"
        "    16 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads\n"
        "ptxas info    : Used 255 registers, 372 bytes cmem[0]\n"
    )
    r = _build.parse_ptxas(text)
    assert list(r) == ["_ZN12_GLOBAL__N_116coissue_q_kernelEPKjS1_PjS2_ix",
                       "_ZN12_GLOBAL__N_18vec_loopEPKjPjii",
                       "_ZN12_GLOBAL__N_116coissue_v_kernelEPKjPji"]
    q, loop, v = r.values()
    assert q == {"stack_bytes": 0, "spill_store_bytes": 0,
                 "spill_load_bytes": 0, "registers": 164, "smem_bytes": 16384}
    assert loop == {"stack_bytes": 8, "spill_store_bytes": 0,
                    "spill_load_bytes": 0}
    assert v == {"stack_bytes": 16, "spill_store_bytes": 4,
                 "spill_load_bytes": 8, "registers": 255, "smem_bytes": 0}
