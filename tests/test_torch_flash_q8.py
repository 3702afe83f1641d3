"""The plain versions of the quantized-KV attention kernels (reached through
the entries with the JAX names, on CPU tensors) against the JAX Pallas
kernels run in interpret mode: K6 flash_decode_stacked, K8a flash_decode_q8,
K8b flash_decode_q8_tiled and K7 flash_prefill_q8, on the same planes (made
by the JAX quantizer, handed over as numpy). f32 throughout. Tolerances are
the JAX package's own (tests/test_flash_q8.py): 2e-4 for the stacked decode,
atol 5e-5 / rtol 1e-4 for the others; both sides dequantize to the same f32
values and differ only in summation order and exp implementation."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llamacog_tpu.ops.pallas import flash_q8 as ref
from llamacog_tpu.runtime.kv_cache import kv_quant_planes
from llamacog_tpu_torch.ops.cuda import flash_q8 as port
from llamacog_tpu_torch.runtime.kv_cache import QuantKVCache

STACKED_TOL = 2e-4
ATOL, RTOL = 5e-5, 1e-4
KIND_PAIRS = [(k, k) for k in ("q8_0", "q4_0", "q4_1", "q5_0", "q5_1")] + [
    ("q8_0", "q5_1"), ("q5_0", "q4_1"), ("bf16", "q4_0"), ("q8_0", "f16")]
pair_id = lambda p: f"{p[0]}-{p[1]}"  # noqa: E731


def _planes(rng, kind, lead, S, Hkv, D):
    """Flat planes [*lead, S, Hkv*W] of random K or V, made by the JAX
    quantizer, as numpy."""
    x = rng.standard_normal((*lead, S, Hkv, D)).astype(np.float32)
    return [np.asarray(p).reshape(*lead, S, -1) for p in kv_quant_planes(kind, jnp.asarray(x))]


def _np(a):
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _decode_inputs(seed, kinds, lead, S, B=2, H=8, Hkv=2, D=32):
    rng = np.random.default_rng(seed)
    kp = _planes(rng, kinds[0], lead, S, Hkv, D)
    vp = _planes(rng, kinds[1], lead, S, Hkv, D)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kc = rng.standard_normal((B, Hkv, D)).astype(np.float32)
    vc = rng.standard_normal((B, Hkv, D)).astype(np.float32)
    return kp, vp, q, kc, vc


def _check(got, want, atol, rtol):
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=rtol)


@pytest.mark.parametrize("softcap,window,kv_cap", [(25.0, 64, 384), (0.0, 0, None)])
@pytest.mark.parametrize("kinds", KIND_PAIRS, ids=pair_id)
def test_decode_stacked_matches_pallas(kinds, softcap, window, kv_cap):
    L, B, S, D = 2, 2, 512, 32
    kp, vp, q, kc, vc = _decode_inputs(1, kinds, (L, B), S)
    seq_len = np.array([300, 17], np.int32)  # rows of different depth
    want = ref.flash_decode_stacked(
        jnp.asarray(q), tuple(map(jnp.asarray, kp)), tuple(map(jnp.asarray, vp)), 1,
        jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(seq_len), D**-0.5, softcap=softcap,
        window=window, interpret=True, kv_cap=kv_cap, kinds=kinds)
    got = port.flash_decode_stacked(
        _np(q), [_np(p) for p in kp], [_np(p) for p in vp], 1, _np(kc), _np(vc),
        _np(seq_len), D**-0.5, softcap=softcap, window=window, kv_cap=kv_cap, kinds=kinds)
    _check(got, want, STACKED_TOL, STACKED_TOL)


@pytest.mark.parametrize("kinds", [("q8_0", "q8_0"), ("q4_1", "q5_0"), ("q5_1", "bf16")],
                         ids=pair_id)
def test_decode_q8_matches_pallas(kinds):
    B, S, D = 2, 512, 32
    kp, vp, q, kc, vc = _decode_inputs(2, kinds, (B,), S)
    seq_len = np.array([40, 511], np.int32)
    want = ref.flash_decode_q8(
        jnp.asarray(q), tuple(map(jnp.asarray, kp)), tuple(map(jnp.asarray, vp)),
        jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(seq_len), D**-0.5, softcap=30.0,
        interpret=True, kinds=kinds)
    got = port.flash_decode_q8(
        _np(q), [_np(p) for p in kp], [_np(p) for p in vp], _np(kc), _np(vc), _np(seq_len),
        D**-0.5, softcap=30.0, kinds=kinds)
    _check(got, want, ATOL, RTOL)


@pytest.mark.parametrize("kinds", [("q8_0", "q8_0"), ("q5_1", "q4_1")], ids=pair_id)
def test_decode_q8_tiled_matches_pallas(kinds):
    B, S, D = 2, 2 * ref.DTS, 32
    kp, vp, q, kc, vc = _decode_inputs(7, kinds, (B,), S)
    seq_len = np.array([ref.DTS + 37, 170], np.int32)
    want = ref.flash_decode_q8_tiled(
        jnp.asarray(q), tuple(map(jnp.asarray, kp)), tuple(map(jnp.asarray, vp)),
        jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(seq_len), D**-0.5, window=1000,
        interpret=True, kinds=kinds)
    args = (_np(q), [_np(p) for p in kp], [_np(p) for p in vp], _np(kc), _np(vc),
            _np(seq_len), D**-0.5)
    _check(port.flash_decode_q8_tiled(*args, window=1000, kinds=kinds), want, ATOL, RTOL)
    # the JAX auto pick sends this S to the tiled kernel; the port's is the same kernel
    _check(port.flash_decode_q8_auto(*args, window=1000, kinds=kinds), want, ATOL, RTOL)


@pytest.mark.parametrize("softcap,window", [(0.0, 0), (25.0, 16)])
@pytest.mark.parametrize("kinds", [("q8_0", "q8_0"), ("q4_0", "q4_0"), ("q5_1", "q5_1"),
                                   ("q8_0", "q5_1"), ("bf16", "q4_0")], ids=pair_id)
def test_prefill_q8_matches_pallas(kinds, softcap, window):
    B, S, T, H, Hkv, D = 2, 512, 16, 8, 2, 32
    rng = np.random.default_rng(4)
    kp = _planes(rng, kinds[0], (B,), S, Hkv, D)
    vp = _planes(rng, kinds[1], (B,), S, Hkv, D)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    kc = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    vc = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    seq_len = np.array([300, 0], np.int32)
    want = ref.flash_prefill_q8(
        jnp.asarray(q), tuple(map(jnp.asarray, kp)), tuple(map(jnp.asarray, vp)),
        jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(seq_len), D**-0.5, softcap=softcap,
        window=window, interpret=True, kinds=kinds)
    got = port.flash_prefill_q8(
        _np(q), [_np(p) for p in kp], [_np(p) for p in vp], _np(kc), _np(vc), _np(seq_len),
        D**-0.5, softcap=softcap, window=window, kinds=kinds)
    _check(got, want, ATOL, RTOL)


# (rep, head dim, kinds): every rep and head dim of the card tests' edges,
# each with another kind pair
PREFILL_EDGES = [(1, 32, ("q8_0", "q8_0")), (4, 64, ("q4_0", "q5_1")), (8, 32, ("q5_0", "q4_1")),
                 (4, 32, ("q4_1", "f16")), (8, 64, ("bf16", "q8_0")), (1, 64, ("q5_1", "q4_0"))]


@pytest.mark.parametrize("T", [1, 8, 16, 17])
@pytest.mark.parametrize("rep,D,kinds", PREFILL_EDGES,
                         ids=[f"rep{r}-D{d}-{pair_id(k)}" for r, d, k in PREFILL_EDGES])
def test_prefill_q8_edges_match_pallas(rep, D, kinds, T):
    """The edges the card tests of K7's tiles rely on, plain version against
    Pallas: B = 2 rows at write offsets on and around the 64-position tile
    grid (0/1, 63/64, 65/1000), T off and on the 16-row MMA tiles, rep 1,
    4 and 8; whole, and with softcap, a 40-position window that cuts tiles
    and kv_cap < S (a multiple of the Pallas kernel's 512-position tile)."""
    B, S, Hkv = 2, 1024, 2
    H = Hkv * rep
    rng = np.random.default_rng(rep * 100 + D + T)
    kp = _planes(rng, kinds[0], (B,), S, Hkv, D)
    vp = _planes(rng, kinds[1], (B,), S, Hkv, D)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    kc = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    vc = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    for lens in ((0, 1), (63, 64), (65, 1000)):
        seq_len = np.array(lens, np.int32)
        for softcap, window, kv_cap in ((0.0, 0, None), (20.0, 40, 512)):
            kw = dict(softcap=softcap, window=window, kv_cap=kv_cap, kinds=kinds)
            want = ref.flash_prefill_q8(
                jnp.asarray(q), tuple(map(jnp.asarray, kp)), tuple(map(jnp.asarray, vp)),
                jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(seq_len), D**-0.5,
                interpret=True, **kw)
            got = port.flash_prefill_q8(
                _np(q), [_np(p) for p in kp], [_np(p) for p in vp], _np(kc), _np(vc),
                _np(seq_len), D**-0.5, **kw)
            _check(got, want, ATOL, RTOL)


def test_decode_from_cache_dispatches_quantized_cache():
    """decode_from_cache sends a QuantKVCache to K6 (here its plain
    version), with the cache's kinds."""
    L, B, S, D, kinds = 2, 2, 64, 32, ("q4_1", "q8_0")
    kp, vp, q, kc, vc = _decode_inputs(5, kinds, (L, B), S)
    cache = QuantKVCache([_np(p) for p in kp], [_np(p) for p in vp], kinds, hkv=2)
    seq_len = _np(np.array([33, 7], np.int32))
    got = port.decode_from_cache(_np(q), cache, 1, _np(kc), _np(vc), seq_len, D**-0.5)
    want = port.flash_decode_stacked_plain(_np(q), cache.k_planes, cache.v_planes, 1,
                                           _np(kc), _np(vc), seq_len, D**-0.5, kinds=kinds)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
