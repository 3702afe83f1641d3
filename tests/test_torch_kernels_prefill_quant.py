"""The quantized-KV prefill kernel K7 (csrc/flash_prefill_quant.cu) against
its plain PyTorch version, on the card: the bf16 tensor-core tiles with the
dequantizing loader, and the SIMT body the C entry runs for f32 and for the
bf16 calls the tiles do not take.

Every test needs an NVIDIA GPU (and nvcc): they carry the `cuda` marker and
skip where none is present. Run them on the card with
`python -m pytest --noconftest tests/test_torch_kernels_prefill_quant.py -m cuda`
(this file imports no JAX). Tolerances, relative to the largest
|reference|, as the other attention kernel tests: f32 1e-5 (summation
order and __expf), bf16 1e-2 (one bf16 rounding of the output on either
side; in the tiles also each dequantized K/V value and P rounded to bf16
before the tensor-core products).
"""

import pytest
import torch

from llamacog_tpu_torch.ops.cuda import build
from llamacog_tpu_torch.ops.cuda.flash_q8 import (
    flash_prefill_q8, flash_prefill_q8_plain, flash_prefill_quant_kernel)
from llamacog_tpu_torch.runtime.kv_cache import QuantKVCache

ATTN_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# the K/V kind pairs of chip_smoke.py's quantized-cache rows, and f16:bf16
KIND_PAIRS = [(k, k) for k in ("q8_0", "q4_0", "q4_1", "q5_0", "q5_1")] + [
    ("q8_0", "q5_1"), ("q5_0", "q4_1"), ("bf16", "q4_0"), ("q8_0", "f16"), ("f16", "bf16")]
pair_id = lambda p: f"{p[0]}-{p[1]}"  # noqa: E731

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def rel_err(got, ref):
    got, ref = got.double(), ref.double()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def _layer(dev, kinds, B, S, Hkv, Dk, Dv, g):
    """One layer's planes [B, S, Hkv*W] of quantized random K/V at every
    slot (layer 1 of a 2-layer cache: views at a layer's offset)."""
    cache = QuantKVCache.create(2, B, S, Hkv, Dk, Dv, kinds=kinds, device=dev)
    k = torch.randn(2, B, S, Hkv, Dk, generator=g, device=dev)
    v = torch.randn(2, B, S, Hkv, Dv, generator=g, device=dev)
    cache.write_all(k, v, torch.zeros(B, dtype=torch.int32, device=dev))
    return [p[1] for p in cache.k_planes], [p[1] for p in cache.v_planes]


def _launched(before):
    return {n: c - before[n] for n, c in build.LAUNCHES.items() if c != before[n]}


def _no_sync(fn):
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.parametrize("rep", [1, 4, 8])
@pytest.mark.parametrize("D", [64, 96, 128])
@pytest.mark.parametrize("kinds", KIND_PAIRS, ids=pair_id)
def test_flash_prefill_quant_tiles_match_plain(dev, kinds, D, rep):
    """The tiles at B = 2 with rows at different write offsets, on and
    around the 64-position tile grid (0/1, 63/64, 65/1000), T 1, 8, 16, 17
    and 128 (GQA rows off and on the 16-row MMA tiles), whole and with
    softcap, a 100-position window that cuts tiles and a kv_cap off the
    grid (700 < S); one tile launch a call, never the SIMT body, no host
    sync."""
    B, S, Hkv = 2, 1024, 2
    H = Hkv * rep
    g = torch.Generator(device=dev).manual_seed(D * 10 + rep)
    kp, vp = _layer(dev, kinds, B, S, Hkv, D, D, g)
    for T in (1, 8, 16, 17, 128):
        q = torch.randn(B, T, H, D, generator=g, device=dev).to(torch.bfloat16)
        kc = torch.randn(B, T, Hkv, D, generator=g, device=dev).to(torch.bfloat16)
        vc = torch.randn(B, T, Hkv, D, generator=g, device=dev).to(torch.bfloat16)
        for lens in ((0, 1), (63, 64), (65, 1000)):
            seq_len = torch.tensor(lens, dtype=torch.int32, device=dev)
            for softcap, window, kv_cap in ((0.0, 0, None), (30.0, 100, 700)):
                args = (q, kp, vp, kc, vc, seq_len, D**-0.5)
                kw = dict(softcap=softcap, window=window, kv_cap=kv_cap, kinds=kinds)
                before = dict(build.LAUNCHES)
                got = _no_sync(lambda: flash_prefill_quant_kernel(*args, **kw))
                assert _launched(before) == {"flash_prefill_quant": 1}
                ref = flash_prefill_q8_plain(*args, **kw)
                torch.cuda.synchronize()
                assert got.shape == (B, T, H, D) and got.dtype == torch.bfloat16
                assert bool(torch.isfinite(got).all())
                err = rel_err(got, ref)
                assert err <= ATTN_TOL[torch.bfloat16], (T, lens, softcap, window, err)


@pytest.mark.parametrize("kinds", [("q8_0", "q8_0"), ("q4_0", "q4_0"), ("q5_1", "q8_0")],
                         ids=pair_id)
def test_flash_prefill_quant_tiles_8b_heads(dev, kinds):
    """The 8B heads (H 32, Hkv 8, D 128) at the engine's chunk lengths:
    T = 128 over 896 old positions (64 blocks) and T = 512 over 1536 (256
    blocks), through the entry with the JAX name."""
    S, H, Hkv, D = 2048, 32, 8, 128
    g = torch.Generator(device=dev).manual_seed(8)
    kp, vp = _layer(dev, kinds, 1, S, Hkv, D, D, g)
    for T, n in ((128, 896), (512, 1536)):
        q = torch.randn(1, T, H, D, generator=g, device=dev).to(torch.bfloat16)
        kc = torch.randn(1, T, Hkv, D, generator=g, device=dev).to(torch.bfloat16)
        vc = torch.randn(1, T, Hkv, D, generator=g, device=dev).to(torch.bfloat16)
        seq_len = torch.tensor([n], dtype=torch.int32, device=dev)
        args = (q, kp, vp, kc, vc, seq_len, D**-0.5)
        before = dict(build.LAUNCHES)
        got = flash_prefill_q8(*args, kinds=kinds)
        assert _launched(before) == {"flash_prefill_quant": 1}
        ref = flash_prefill_q8_plain(*args, kinds=kinds)
        torch.cuda.synchronize()
        assert rel_err(got, ref) <= ATTN_TOL[torch.bfloat16], (T, n)


@pytest.mark.parametrize("kinds", KIND_PAIRS, ids=pair_id)
def test_flash_prefill_quant_simt_f32(dev, kinds):
    """f32 runs the SIMT body (counted as flash_prefill_quant_simt), at the
    test shapes of the tiles' edges."""
    B, S, H, Hkv, D = 2, 1024, 8, 2, 128
    g = torch.Generator(device=dev).manual_seed(5)
    kp, vp = _layer(dev, kinds, B, S, Hkv, D, D, g)
    for T, lens in ((17, (65, 1000)), (128, (0, 63))):
        q = torch.randn(B, T, H, D, generator=g, device=dev)
        kc = torch.randn(B, T, Hkv, D, generator=g, device=dev)
        vc = torch.randn(B, T, Hkv, D, generator=g, device=dev)
        seq_len = torch.tensor(lens, dtype=torch.int32, device=dev)
        for softcap, window, kv_cap in ((0.0, 0, None), (30.0, 100, 700)):
            args = (q, kp, vp, kc, vc, seq_len, D**-0.5)
            kw = dict(softcap=softcap, window=window, kv_cap=kv_cap, kinds=kinds)
            before = dict(build.LAUNCHES)
            got = flash_prefill_quant_kernel(*args, **kw)
            assert _launched(before) == {"flash_prefill_quant_simt": 1}
            ref = flash_prefill_q8_plain(*args, **kw)
            torch.cuda.synchronize()
            assert got.dtype == torch.float32
            assert rel_err(got, ref) <= ATTN_TOL[torch.float32], (T, lens, softcap)


@pytest.mark.parametrize("case", ["Dk64-Dv128", "q-off-16-bytes", "f16-f16-D256"])
def test_flash_prefill_quant_simt_bf16_off_tiles(dev, case):
    """bf16 calls the tiles do not take run the SIMT body: a head-dim pair
    outside the tile list, a q one element off 16 bytes, and f16 planes at
    head dim 256 (the tiles and two staging slots outgrow the block's
    shared memory)."""
    B, S, T, Hkv, rep = 2, 512, 37, 2, 4
    H = Hkv * rep
    Dk, Dv, kinds, shift = {"Dk64-Dv128": (64, 128, ("q8_0", "q4_1"), 0),
                            "q-off-16-bytes": (128, 128, ("q8_0", "q8_0"), 1),
                            "f16-f16-D256": (256, 256, ("f16", "f16"), 0)}[case]
    g = torch.Generator(device=dev).manual_seed(6)
    kp, vp = _layer(dev, kinds, B, S, Hkv, Dk, Dv, g)
    flat = torch.randn(B * T * H * Dk + shift, generator=g, device=dev).to(torch.bfloat16)
    q = flat[shift:].view(B, T, H, Dk)
    kc = torch.randn(B, T, Hkv, Dk, generator=g, device=dev).to(torch.bfloat16)
    vc = torch.randn(B, T, Hkv, Dv, generator=g, device=dev).to(torch.bfloat16)
    seq_len = torch.tensor([300, 64], dtype=torch.int32, device=dev)
    args = (q, kp, vp, kc, vc, seq_len, Dk**-0.5)
    before = dict(build.LAUNCHES)
    got = flash_prefill_quant_kernel(*args, window=100, kinds=kinds)
    assert _launched(before) == {"flash_prefill_quant_simt": 1}
    ref = flash_prefill_q8_plain(*args, window=100, kinds=kinds)
    torch.cuda.synchronize()
    assert got.shape == (B, T, H, Dv)
    assert rel_err(got, ref) <= ATTN_TOL[torch.bfloat16]
