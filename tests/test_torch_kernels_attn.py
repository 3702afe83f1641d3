"""The dense attention kernels — prefill K5 (csrc/flash_prefill.cu, tensor
cores in bf16) and split-S decode K4/K9 (csrc/flash_decode_dense.cu) —
against their plain PyTorch versions, on the card; and multi-query heads
(32, 48 and 71 query heads over one kv head) through K4-K7, the quantized
ones over q8_0 planes.

Every test needs an NVIDIA GPU (and nvcc): they carry the `cuda` marker and
skip where none is present. Run them on the card with
`python -m pytest --noconftest tests/test_torch_kernels_attn.py -m cuda`
(this file imports no JAX). Tolerances, relative to the largest
|reference|, as the other attention kernel tests: f32 1e-5 (summation
order and __expf), bf16 1e-2 (one bf16 rounding of the output on either
side; in K5 also P rounded to bf16 before the PV product).
"""

import pytest
import torch

from llamacog_tpu_torch.ops.cuda import build
from llamacog_tpu_torch.ops.cuda.flash_decode import (
    flash_decode_attention_plain, flash_decode_kernel)
from llamacog_tpu_torch.ops.cuda.flash_prefill import (
    flash_prefill_attention_plain, flash_prefill_kernel)
from llamacog_tpu_torch.ops.cuda.flash_q8 import (
    choose_splits, flash_decode_stacked, flash_decode_stacked_dense,
    flash_decode_stacked_dense_plain, flash_decode_stacked_plain, flash_prefill_q8,
    flash_prefill_q8_plain)
from llamacog_tpu_torch.runtime.kv_cache import QuantKVCache

ATTN_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
DTYPES = [torch.float32, torch.bfloat16]
# (head dim, kv heads): the test shape and the 8B shape, rep 4 both
HEADS = [(64, 2), (128, 8)]

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def rel_err(got, ref):
    got, ref = got.double(), ref.double()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def _no_sync(fn):
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.parametrize("softcap,window", [(0.0, 0), (30.0, 0), (0.0, 100)])
@pytest.mark.parametrize("T", [1, 16, 37, 128, 512])
@pytest.mark.parametrize("D,Hkv", HEADS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_prefill_matches_plain(dev, dtype, D, Hkv, T, softcap, window):
    """Rows at write offsets 250 and 1000 (off the 64-position tile grid)
    and 0, over layer 1 of a stacked cache sliced to 1024 slots (a strided
    view); a window of 100 crosses tile edges."""
    B, S, H = 3, 1024, 4 * Hkv
    g = torch.Generator(device=dev).manual_seed(T + D)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev).to(dtype)  # noqa: E731
    ck, cv = rnd(2, B, S + 40, Hkv, D), rnd(2, B, S + 40, Hkv, D)
    k, v = ck[1, :, :S], cv[1, :, :S]
    q, kc, vc = rnd(B, T, H, D), rnd(B, T, Hkv, D), rnd(B, T, Hkv, D)
    seq = torch.tensor([250, 1000, 0], dtype=torch.int32, device=dev)
    body = "flash_prefill" if dtype == torch.bfloat16 else "flash_prefill_simt"
    before = dict(build.LAUNCHES)
    got = _no_sync(lambda: flash_prefill_kernel(q, k, v, kc, vc, seq, D**-0.5, softcap, window))
    assert {n: c - before[n] for n, c in build.LAUNCHES.items() if c != before[n]} == {body: 1}
    ref = flash_prefill_attention_plain(q, k, v, kc, vc, seq, D**-0.5, softcap, window)
    torch.cuda.synchronize()
    assert got.shape == (B, T, H, D) and got.dtype == dtype
    assert bool(torch.isfinite(got).all())
    assert rel_err(got, ref) <= ATTN_TOL[dtype]


@pytest.mark.parametrize("T", [37, 128])
@pytest.mark.parametrize("Dk,Dv", [(16, 16), (48, 48), (80, 80), (112, 112), (192, 192),
                                   (256, 256), (192, 128), (96, 64)])
def test_flash_prefill_bf16_head_dims(dev, Dk, Dv, T):
    """The tensor-core tiles at the other head dims the bf16 route takes
    (phi-2's 80, gemma's 256, deepseek2's 192/128, minicpm3's 96/64 among
    them), with softcap
    and a window, rows at write offsets 250, 1000 and 0."""
    B, S, Hkv, H = 3, 1024, 2, 8
    g = torch.Generator(device=dev).manual_seed(Dk + Dv + T)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)  # noqa: E731
    k, v = rnd(B, S, Hkv, Dk), rnd(B, S, Hkv, Dv)
    q, kc, vc = rnd(B, T, H, Dk), rnd(B, T, Hkv, Dk), rnd(B, T, Hkv, Dv)
    seq = torch.tensor([250, 1000, 0], dtype=torch.int32, device=dev)
    before = build.LAUNCHES["flash_prefill"]
    got = flash_prefill_kernel(q, k, v, kc, vc, seq, Dk**-0.5, 30.0, 100)
    assert build.LAUNCHES["flash_prefill"] == before + 1  # the tiles, not the SIMT body
    ref = flash_prefill_attention_plain(q, k, v, kc, vc, seq, Dk**-0.5, 30.0, 100)
    torch.cuda.synchronize()
    assert got.shape == (B, T, H, Dv) and bool(torch.isfinite(got).all())
    assert rel_err(got, ref) <= ATTN_TOL[torch.bfloat16]


@pytest.mark.parametrize("T", [37, 128])
@pytest.mark.parametrize("Dk,Dv,misaligned", [(8, 8, False), (40, 40, False), (72, 72, False),
                                              (64, 128, False), (64, 64, True),
                                              (128, 128, True)])
def test_flash_prefill_bf16_simt_head_dims(dev, Dk, Dv, misaligned, T):
    """bf16 calls the tensor-core tiles do not take run the bf16 SIMT body:
    head dims that are not a tile's (8, 40, 72, Dk != Dv but 192/128 and
    96/64) and a
    cache view whose rows are not 16-byte aligned (one element off), with
    softcap and a window, rows at write offsets 250, 1000 and 0."""
    B, S, Hkv, H = 3, 1024, 2, 8
    g = torch.Generator(device=dev).manual_seed(Dk + Dv + T)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)  # noqa: E731
    if misaligned:
        flat = rnd(B * S * Hkv * Dk + 1)
        k = flat[1:].view(B, S, Hkv, Dk)
        assert k.data_ptr() % 16
    else:
        k = rnd(B, S, Hkv, Dk)
    v = rnd(B, S, Hkv, Dv)
    q, kc, vc = rnd(B, T, H, Dk), rnd(B, T, Hkv, Dk), rnd(B, T, Hkv, Dv)
    seq = torch.tensor([250, 1000, 0], dtype=torch.int32, device=dev)
    before = dict(build.LAUNCHES)
    got = flash_prefill_kernel(q, k, v, kc, vc, seq, Dk**-0.5, 30.0, 100)
    assert {n: c - before[n] for n, c in build.LAUNCHES.items() if c != before[n]} == {
        "flash_prefill_simt": 1}
    ref = flash_prefill_attention_plain(q, k, v, kc, vc, seq, Dk**-0.5, 30.0, 100)
    torch.cuda.synchronize()
    assert got.shape == (B, T, H, Dv) and got.dtype == torch.bfloat16
    assert bool(torch.isfinite(got).all())
    assert rel_err(got, ref) <= ATTN_TOL[torch.bfloat16]


def test_flash_prefill_refuses_bad_inputs(dev):
    """What neither body takes: head dims above 256, H not a multiple of
    Hkv, float16; the valid calls at a tile dim and at dim 72 in both types
    run."""
    bf = torch.bfloat16
    B, T, H, Hkv, S = 1, 8, 8, 2, 64

    def args(D, dt=bf, Hq=H):
        z = lambda *s: torch.zeros(*s, dtype=dt, device=dev)  # noqa: E731
        return (z(B, T, Hq, D), z(B, S, Hkv, D), z(B, S, Hkv, D), z(B, T, Hkv, D),
                z(B, T, Hkv, D), torch.zeros(B, dtype=torch.int32, device=dev), 1.0)

    for ok in (args(64), args(72), args(72, torch.float32)):
        flash_prefill_kernel(*ok)
    for bad in (args(264), args(64, Hq=7), args(64, torch.float16)):
        with pytest.raises(ValueError):
            flash_prefill_kernel(*bad)


def _decode_lens(s_eff, B, Hkv):
    """seq_len triples at 0, 1, 1000 (past a kv_cap of 512: the cap cuts
    it) and every split boundary +-1."""
    _, length = choose_splits(s_eff, B, Hkv)
    lens = [0, 1, 1000]
    for edge in range(length, s_eff + 1, length):
        lens += [edge - 1, edge, min(edge + 1, s_eff)]
    return [lens[i:i + 3] + [0] * (3 - len(lens[i:i + 3])) for i in range(0, len(lens), 3)]


@pytest.mark.parametrize("softcap,window", [(0.0, 0), (30.0, 0), (0.0, 100)])
@pytest.mark.parametrize("kv_cap", [None, 512])
@pytest.mark.parametrize("D,Hkv", HEADS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_decode_dense_matches_plain(dev, dtype, D, Hkv, kv_cap, softcap, window):
    """K4 on layer 1 of a stacked cache, B = 3 rows of unequal seq_len:
    0, 1, each split boundary +-1 and 1000, whole and as a kv_cap slice.
    K9 on the same layer (one [B, S, Hkv, D] view) gives the same output."""
    L, B, S, H = 2, 3, 1024, 4 * Hkv
    g = torch.Generator(device=dev).manual_seed(D + (kv_cap or 0))
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev).to(dtype)  # noqa: E731
    ks, vs = rnd(L, B, S, Hkv, D), rnd(L, B, S, Hkv, D)
    q, kc, vc = rnd(B, H, D), rnd(B, Hkv, D), rnd(B, Hkv, D)
    s_eff = S if kv_cap is None else kv_cap
    for lens in _decode_lens(s_eff, B, Hkv):
        seq = torch.tensor(lens, dtype=torch.int32, device=dev)
        build.reset_launches()
        got = _no_sync(lambda: flash_decode_stacked_dense(
            q, ks, vs, 1, kc, vc, seq, D**-0.5, softcap=softcap, window=window, kv_cap=kv_cap))
        k9 = _no_sync(lambda: flash_decode_kernel(
            q, ks[1, :, :s_eff], vs[1, :, :s_eff], kc, vc, seq, D**-0.5, softcap=softcap,
            window=window))
        assert build.LAUNCHES["flash_decode_dense"] == 1 and build.LAUNCHES["flash_decode"] == 1
        ref = flash_decode_stacked_dense_plain(q, ks, vs, 1, kc, vc, seq, D**-0.5,
                                               softcap=softcap, window=window, kv_cap=kv_cap)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all()), lens
        assert rel_err(got, ref) <= ATTN_TOL[dtype], lens
        assert torch.equal(got, k9), lens


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_decode_dense_at_depth(dev, dtype):
    """The 8B heads at seq_len 32765 of 32768 slots (33 splits), and 1000 in
    the same cache (all but the first splits past seq_len); K9 as well."""
    B, S, H, Hkv, D = 1, 32768, 32, 8, 128
    g = torch.Generator(device=dev).manual_seed(7)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev).to(dtype)  # noqa: E731
    ks, vs = rnd(1, B, S, Hkv, D), rnd(1, B, S, Hkv, D)
    q, kc, vc = rnd(B, H, D), rnd(B, Hkv, D), rnd(B, Hkv, D)
    for n in (32765, 1000):
        seq = torch.tensor([n], dtype=torch.int32, device=dev)
        got = flash_decode_stacked_dense(q, ks, vs, 0, kc, vc, seq, D**-0.5)
        k9 = flash_decode_kernel(q, ks[0], vs[0], kc, vc, seq, D**-0.5)
        ref = flash_decode_attention_plain(q, ks[0], vs[0], kc, vc, seq, D**-0.5)
        torch.cuda.synchronize()
        assert rel_err(got, ref) <= ATTN_TOL[dtype] and torch.equal(got, k9)


@pytest.mark.parametrize("H,D", [(32, 128), (48, 128), (71, 64)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_multi_query_heads(dev, dtype, H, D):
    """StarCoderBase-7B's 32, StarCoder's 48 and Falcon-7B's 71 query heads
    over one kv head: K4 and K6 (q8_0 planes; head groups of 8 past 16
    heads) at depths 1000 and 32765 of 32768 slots, and K5 and K7 over a
    128-token block from offsets 0 and 896 of 1024 slots, each against its
    plain version."""
    kinds = ("q8_0", "q8_0")
    g = torch.Generator(device=dev).manual_seed(H)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev).to(dtype)  # noqa: E731
    for S, depths in ((32768, (32765, 1000)), (1024, ())):
        ks, vs = rnd(1, 1, S, 1, D), rnd(1, 1, S, 1, D)
        cache = QuantKVCache.create(1, 1, S, 1, D, D, kinds=kinds, device=dev)
        cache = cache.write_all(ks.float(), vs.float(), torch.zeros(1, dtype=torch.int32,
                                                                     device=dev))
        q, kc, vc = rnd(1, H, D), rnd(1, 1, D), rnd(1, 1, D)
        for n in depths:
            seq = torch.tensor([n], dtype=torch.int32, device=dev)
            got = _no_sync(lambda: flash_decode_stacked_dense(q, ks, vs, 0, kc, vc, seq,
                                                              D**-0.5))
            ref = flash_decode_stacked_dense_plain(q, ks, vs, 0, kc, vc, seq, D**-0.5)
            args = (q, cache.k_planes, cache.v_planes, 0, kc, vc, seq, D**-0.5)
            got_q = _no_sync(lambda: flash_decode_stacked(*args, kinds=kinds))
            ref_q = flash_decode_stacked_plain(*args, kinds=kinds)
            torch.cuda.synchronize()
            assert rel_err(got, ref) <= ATTN_TOL[dtype], (n, "K4")
            assert rel_err(got_q, ref_q) <= ATTN_TOL[dtype], (n, "K6")
    qp, kcp, vcp = rnd(1, 128, H, D), rnd(1, 128, 1, D), rnd(1, 128, 1, D)
    kp, vp = [p[0] for p in cache.k_planes], [p[0] for p in cache.v_planes]
    for n in (0, 896):
        seq = torch.tensor([n], dtype=torch.int32, device=dev)
        got = _no_sync(lambda: flash_prefill_kernel(qp, ks[0], vs[0], kcp, vcp, seq, D**-0.5))
        ref = flash_prefill_attention_plain(qp, ks[0], vs[0], kcp, vcp, seq, D**-0.5)
        got_q = _no_sync(lambda: flash_prefill_q8(qp, kp, vp, kcp, vcp, seq, D**-0.5,
                                                  kinds=kinds))
        ref_q = flash_prefill_q8_plain(qp, kp, vp, kcp, vcp, seq, D**-0.5, kinds=kinds)
        torch.cuda.synchronize()
        assert rel_err(got, ref) <= ATTN_TOL[dtype], (n, "K5")
        assert rel_err(got_q, ref_q) <= ATTN_TOL[dtype], (n, "K7")
