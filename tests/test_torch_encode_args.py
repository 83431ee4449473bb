"""``encode_bytes`` / ``compress`` refuse what the chosen pipeline does not
run, as the JAX package does, where they used to drop it.

The fused pipeline (``compress``'s default) takes every matcher name, as
the JAX package's does; an unknown one raises ``ValueError`` with
``route_matcher``'s text, which the JAX package's ``compress`` also raises.
An argument
that only the other pipeline takes raises ``TypeError``, as the JAX
package's ``encode_bytes`` does for ``sub_block``.  On the CPU, so the
kernels' plain versions.
"""

import pytest
import torch

import lz77_tpu
import lz77_tpu_torch as lt
from lz77_tpu import spec
from lz77_tpu_torch.utils import faults
from lz77_tpu_torch.models import codec, fused

torch.set_num_threads(1)

DATA = b"abcabcabd" * 40 + b"\x00" * 300 + b"the cat sat on the mat " * 9


@pytest.mark.parametrize("matcher,text", [
    ("bogus", "unknown matcher"),
    ("brute", None),             # an XLA matcher of the JAX package
    ("chunk", None),
    ("pallas", None),            # alias of chunk
])
def test_fused_refuses_other_matchers(matcher, text):
    """The name dates from when the fused pipeline ran the sweep alone: an
    unknown name is still refused, every other name runs and gives the JAX
    package's stream."""
    if text is None:
        want = lz77_tpu.compress(DATA, backend="numpy")
        assert lt.compress(DATA, device="cpu", matcher=matcher) == want
        assert codec.encode_bytes(DATA, pipeline="fused", matcher=matcher,
                                  device="cpu") == want
        return
    with pytest.raises(ValueError, match=text):
        fused.encode_bytes_fused(DATA, matcher=matcher, device="cpu")
    with pytest.raises(ValueError, match=text):
        lt.compress(DATA, device="cpu", matcher=matcher)
    with pytest.raises(ValueError, match=text):
        codec.encode_bytes(DATA, pipeline="fused", matcher=matcher,
                           device="cpu")
    with pytest.raises(ValueError, match="unknown matcher"):
        lz77_tpu.compress(DATA, backend="jax", matcher="bogus")


@pytest.mark.parametrize("pipeline,kwargs", [
    ("fused", {"retries": 2}),
    ("fused", {"retries": 0}),
    ("fused", {"fault_injector": None}),
    ("fused", {"fault_injector": "injector"}),
    ("host", {"sub_block": 512}),
    ("host", {"sub_block": None}),
], ids=["fused_retries", "fused_retries0", "fused_injector_none",
        "fused_injector", "host_sub_block", "host_sub_block_none"])
def test_arguments_of_the_other_pipeline_raise(pipeline, kwargs):
    """Given at all, even as the other pipeline's default, an argument the
    chosen pipeline does not take raises before anything runs."""
    if kwargs.get("fault_injector") == "injector":
        kwargs = {"fault_injector": faults.FaultInjector({})}
    name = next(iter(kwargs))
    with pytest.raises(TypeError, match=f"{pipeline}.*{name}"):
        codec.encode_bytes(DATA, pipeline=pipeline, device="cpu", **kwargs)
    with pytest.raises(TypeError, match=name):
        lt.compress(DATA, device="cpu", pipeline=pipeline, **kwargs)


@pytest.mark.parametrize("pipeline,kwargs", [
    ("fused", {}),
    ("fused", {"matcher": "sweep", "sub_block": 64}),
    ("fused", {"matcher": "pallas_bitplane", "sub_block": None}),
    ("host", {}),
    ("host", {"matcher": "chunk", "retries": 1, "fault_injector": None}),
], ids=["fused_defaults", "fused_sweep", "fused_alias", "host_defaults",
        "host_chunk"])
def test_what_each_pipeline_takes_gives_the_jax_stream(pipeline, kwargs):
    for params in (spec.Params(), spec.Params(la=255, sb=255)):
        want = lz77_tpu.compress(DATA, params.la, params.sb, backend="numpy")
        got = lt.compress(DATA, params.la, params.sb, device="cpu",
                          pipeline=pipeline, **kwargs)
        assert got == want
