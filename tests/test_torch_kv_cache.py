"""The port's KV cache codecs and quantized cache against the JAX package.

The planes keep the JAX layout, so everything here is held bit for bit:
the quantizer and the dequantizer for all seven kinds (on input with an
all-zero group and a group with tied maxima), the planes after
QuantKVCache.write_all, the kind parsing and the cache make_cache picks.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llamacog_tpu.runtime import kv_cache as ref
from llamacog_tpu_torch.convert import kv_cache_from_reference
from llamacog_tpu_torch.runtime import kv_cache as port

ALL_KINDS = ref.KV_QUANT_KINDS + ref.KV_DENSE_KINDS
# every kind pair worth distinguishing (tests/test_flash_q8.py::KIND_PAIRS)
KIND_PAIRS = [(k, k) for k in ref.KV_QUANT_KINDS] + [
    ("q8_0", "q5_1"), ("q5_0", "q4_1"), ("bf16", "q4_0"), ("q8_0", "f16")]


def bits(a) -> np.ndarray:
    """An array's raw bits (bfloat16 and float as unsigned ints), so equality
    is bit for bit and -0.0 differs from 0.0."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        a = a.numpy()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    return a.view({2: np.uint16, 4: np.uint32}[a.itemsize]) if a.dtype.kind == "f" else a


def _kv_input(seed=0, shape=(3, 5, 2, 64)):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x[0, 0, 0, :32] = 0.0                       # an all-zero group
    x[0, 1, 1, 32:] = 0.25
    x[0, 1, 1, [35, 40]] = [1.5, -1.5]          # tied maxima of |x|
    x[1, 2, 0, :32] = np.linspace(-2.0, 2.0, 32)  # tied min/max magnitude
    return x


@pytest.mark.parametrize("kind", ALL_KINDS)
def test_codecs_bit_exact_against_jax(kind):
    x = _kv_input()
    want = ref.kv_quant_planes(kind, jnp.asarray(x))
    got = port.kv_quant_planes(kind, torch.from_numpy(x))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(bits(g), bits(w))
    deq_want = ref.kv_dequant_planes(kind, want, jnp.float32)
    deq_got = port.kv_dequant_planes(kind, got, torch.float32)
    np.testing.assert_array_equal(bits(deq_got), bits(deq_want))
    for (shape, dt), p in zip(port.kv_plane_shapes(kind, 64), got):
        assert p.dtype == dt and tuple(p.shape[-1:]) == shape


def test_permute_roundtrip_matches_jax():
    x = _kv_input(1)
    np.testing.assert_array_equal(port.kv_permute(torch.from_numpy(x)).numpy(),
                                  np.asarray(ref.QuantKVCache.kv_permute(jnp.asarray(x))))
    np.testing.assert_array_equal(
        port.kv_unpermute(port.kv_permute(torch.from_numpy(x))).numpy(), x)


@pytest.mark.parametrize("kinds", KIND_PAIRS, ids=lambda p: f"{p[0]}-{p[1]}")
def test_write_all_planes_match_jax(kinds):
    """A prefill block at per-row offsets, then a decode step: every plane
    equals the JAX cache's after each write."""
    L, B, S, Hkv, Dk, Dv, T = 2, 2, 48, 2, 64, 32, 8
    rng = np.random.default_rng(2)
    jc = ref.QuantKVCache.create(L, B, S, Hkv, Dk, Dv, kinds=kinds)
    pc = port.QuantKVCache.create(L, B, S, Hkv, Dk, Dv, kinds=kinds)
    pos = np.array([0, 5], np.int32)
    for t in (T, 1):
        k = rng.standard_normal((L, B, t, Hkv, Dk)).astype(np.float32)
        v = rng.standard_normal((L, B, t, Hkv, Dv)).astype(np.float32)
        jc = jc.write_all(jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos))
        assert pc.write_all(torch.from_numpy(k), torch.from_numpy(v),
                            torch.from_numpy(pos)) is pc
        for got, want in zip(pc.k_planes + pc.v_planes, jc.k_planes + jc.v_planes):
            np.testing.assert_array_equal(bits(got), bits(want))
        pos = pos + t
    for il in range(L):
        for got, want in zip(pc.read(il), jc.read(il)):
            np.testing.assert_array_equal(bits(got), bits(want))


@pytest.mark.parametrize("kind", ["q8_0", "q4", "q8", "dense", "f32", "bf16", "f16",
                                  "q5_0:q4_1", "bf16:q4_0", "q8_0:dense", "f16:q5_1",
                                  "q4_0:q4_0"])
def test_make_cache_matches_jax(kind):
    assert port.parse_kv_kinds(kind) == ref.parse_kv_kinds(kind)
    want = ref.make_cache(kind, 2, 1, 64, 2, 64, 64, dtype=jnp.float32)
    got = port.make_cache(kind, 2, 1, 64, 2, 64, 64, dtype=torch.float32, device="cpu")
    assert type(got).__name__ == type(want).__name__
    if isinstance(want, ref.KVCache):
        assert got.k.dtype == torch.float32 and tuple(got.k.shape) == want.k.shape
        return
    assert got.kinds == want.kinds and got.hkv == want.hkv
    for g, w in zip(got.k_planes + got.v_planes, want.k_planes + want.v_planes):
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).split(".")[-1] == w.dtype.name


@pytest.mark.parametrize("kind", ["q9_0", "q8_0:q4_0:q4_0", "int8", ""])
def test_unknown_kinds_raise_value_error(kind):
    with pytest.raises(ValueError):
        ref.parse_kv_kinds(kind)
    with pytest.raises(ValueError):
        port.parse_kv_kinds(kind)


@pytest.mark.parametrize("kinds", [None, ("q8_0", "q8_0"), ("q4_0", "q4_0"),
                                   ("bf16", "q5_1")], ids=str)
def test_kv_cache_from_reference_carries_planes(kinds):
    L, B, S, Hkv, D = 2, 1, 16, 2, 64
    rng = np.random.default_rng(3)
    k = rng.standard_normal((L, B, 4, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((L, B, 4, Hkv, D)).astype(np.float32)
    pos = jnp.asarray(np.array([3], np.int32))
    if kinds is None:
        jc = ref.KVCache.create(L, B, S, Hkv, D, D).write_all(jnp.asarray(k), jnp.asarray(v),
                                                               pos)
        got = kv_cache_from_reference((np.asarray(jc.k),), (np.asarray(jc.v),), None, Hkv,
                                      device="cpu")
        assert isinstance(got, port.KVCache) and got.k.dtype == torch.bfloat16
        np.testing.assert_array_equal(bits(got.k), bits(jc.k))
        return
    jc = ref.make_cache(f"{kinds[0]}:{kinds[1]}", L, B, S, Hkv, D, D)
    jc = jc.write_all(jnp.asarray(k), jnp.asarray(v), pos)
    got = kv_cache_from_reference([np.asarray(p) for p in jc.k_planes],
                                  [np.asarray(p) for p in jc.v_planes], jc.kinds, jc.hkv,
                                  device="cpu")
    assert type(got).__name__ == type(jc).__name__ and got.kinds == jc.kinds
    for g, w in zip(got.k_planes + got.v_planes, jc.k_planes + jc.v_planes):
        np.testing.assert_array_equal(bits(g), bits(w))
