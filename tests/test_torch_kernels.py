"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (and nvcc to build the kernels): they
carry the `cuda` marker and skip where no GPU is present. Run them on the
card with `python -m pytest tests/test_torch_kernels.py -m cuda`.
Tolerances, relative to the largest |reference|: the qmm kernels form every
dequantized weight exactly as the plain version does and differ only in
f32 summation order (QMM_TOL); the attention kernels differ in summation
order and __expf, ~1e-6 in f32, and bf16 outputs by one bf16 rounding
(2^-8) of either side. The MoE kernels (qmv_id, qgemm_id) form their
weights as qmv and qgemm do: QMM_TOL.
"""

import pytest
import torch

from llamacog_tpu_torch.ops.cuda import build
from llamacog_tpu_torch.ops.cuda.flash_prefill import (
    flash_prefill_attention_plain, flash_prefill_kernel)
from llamacog_tpu_torch.ops.cuda.flash_q8 import (
    flash_decode_q8, flash_decode_quant_kernel, flash_decode_stacked_dense,
    flash_decode_stacked_dense_plain, flash_decode_stacked_plain, flash_prefill_q8_plain,
    flash_prefill_quant_kernel)
from llamacog_tpu_torch.ops.cuda.qmm import qgemm, qmm_plain, qmv
from llamacog_tpu_torch.ops.cuda.qmm_id import (
    qgemm_id_kernel, qmm_gather, qmm_gather_offset, qmm_gather_plain, qmm_ragged,
    qmm_ragged_plain, qmv_id_kernel)
from llamacog_tpu_torch.quant.wire import BLOCK_BYTES, WireTensor
from llamacog_tpu_torch.runtime.kv_cache import QuantKVCache
from llamacog_tpu_torch.utils.synthetic import random_experts, random_wire

QMM_TOL = 1e-4
# the quantized-KV kernels dequantize every element bit for bit as the plain
# version does: the same tolerances as the dense attention kernels
ATTN_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
KIND_PAIRS = [(k, k) for k in ("q8_0", "q4_0", "q4_1", "q5_0", "q5_1")] + [
    ("q8_0", "q5_1"), ("q5_0", "q4_1"), ("bf16", "q4_0"), ("q8_0", "f16")]

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def rel_err(got, ref):
    got, ref = got.double(), ref.double()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("kind", ["Q4_K", "Q6_K"])
@pytest.mark.parametrize("B,dtype", [(1, torch.float32), (3, torch.float32),
                                     (8, torch.float32), (33, torch.float32),
                                     (1, torch.bfloat16), (8, torch.bfloat16)])
def test_qmv_matches_plain(dev, kind, B, dtype):
    g = torch.Generator(device=dev).manual_seed(B)
    w = random_wire(kind, 200, 1024, g, dev)  # N not a multiple of the block rows
    x = torch.randn(B, 1024, generator=g, device=dev).to(dtype)
    got, = qmv(x, [w])
    torch.cuda.synchronize()
    assert rel_err(got, qmm_plain(x, w)) < QMM_TOL


@pytest.mark.parametrize("B", [9, 33, 130])
def test_qgemm_multi_matches_plain(dev, B):
    g = torch.Generator(device=dev).manual_seed(B)
    ws = [random_wire("Q4_K", 160, 512, g, dev), random_wire("Q6_K", 72, 512, g, dev)]
    x = torch.randn(B, 512, generator=g, device=dev).to(torch.bfloat16)
    outs = qgemm(x, ws)
    torch.cuda.synchronize()
    for got, w in zip(outs, ws):
        assert got.shape == (B, w.shape[0])
        assert rel_err(got, qmm_plain(x, w)) < QMM_TOL


def test_qmv_multi_launch_counts_once(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    ws = [random_wire("Q4_K", 64, 256, g, dev), random_wire("Q6_K", 24, 256, g, dev)]
    x = torch.randn(1, 256, generator=g, device=dev)
    before = build.LAUNCHES["qmv"]
    outs = qmv(x, ws)
    assert build.LAUNCHES["qmv"] == before + 1
    for got, w in zip(outs, ws):
        assert rel_err(got, qmm_plain(x, w)) < QMM_TOL


def test_qmm_launchers_reject_bad_input(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    w = random_wire("Q4_K", 64, 256, g, dev)
    with pytest.raises(ValueError):
        qgemm(torch.zeros(9, 256, device=dev), [w])  # f32 x: qmv's job
    with pytest.raises(ValueError):
        qmv(torch.zeros(1, 512, device=dev), [w])  # K mismatch
    with pytest.raises(ValueError):
        qmv(torch.zeros(1, 256, device=dev, dtype=torch.float16), [w])


@pytest.mark.parametrize("kind", ["Q4_K", "Q6_K"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 2, 32])
def test_qmv_id_matches_plain(dev, kind, dtype, S):
    g = torch.Generator(device=dev).manual_seed(S)
    w = random_experts(kind, 8, 200, 1024, g, dev)  # N not a multiple of the block rows
    x = torch.randn(S, 1024, generator=g, device=dev).to(dtype)
    ids = torch.randint(0, 8, (S,), generator=g, device=dev, dtype=torch.int32)
    before = build.LAUNCHES["qmv_id"]
    got = qmm_gather(x, ids, w)
    assert build.LAUNCHES["qmv_id"] == before + 1
    torch.cuda.synchronize()
    assert got.shape == (S, 200) and rel_err(got, qmm_gather_plain(x, ids, w)) < QMM_TOL
    assert torch.equal(qmm_gather_offset(x, ids, w), got)  # K12: the same kernel


# tile -> expert maps: every expert, empty experts between used ones, one
# expert, and padding tiles (expert n_exp) past the last used one
TILE_MAPS = [[0, 1, 2, 3], [0, 0, 3, 3, 3, 4, 4], [2], [1, 3, 3, 4, 4, 4]]


@pytest.mark.parametrize("kind", ["Q4_K", "Q6_K"])
@pytest.mark.parametrize("tiles", TILE_MAPS, ids=lambda t: "-".join(map(str, t)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qgemm_id_matches_plain(dev, kind, tiles, dtype):
    """bf16 takes qgemm_id; f32 the qmv_id kernel over repeated tile ids."""
    g = torch.Generator(device=dev).manual_seed(len(tiles))
    w = random_experts(kind, 4, 160, 512, g, dev)
    te = torch.tensor(tiles, dtype=torch.int32, device=dev)
    xs = torch.randn(64 * len(tiles), 512, generator=g, device=dev).to(dtype)
    counter = "qgemm_id" if dtype == torch.bfloat16 else "qmv_id"
    before = build.LAUNCHES[counter]
    got = qmm_ragged(xs, te, w, 64)
    assert build.LAUNCHES[counter] == before + 1
    torch.cuda.synchronize()
    ref = qmm_ragged_plain(xs, te, w, 64)
    assert got.shape == (xs.shape[0], 160) and rel_err(got, ref) < QMM_TOL
    pad = (te >= 4).repeat_interleave(64)
    assert (got[pad] == 0).all()


def test_moe_launchers_reject_bad_input(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    w = random_experts("Q4_K", 4, 64, 256, g, dev)
    te = torch.zeros(1, dtype=torch.int32, device=dev)
    xs = torch.zeros(64, 256, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):  # the kernel's token tile is 64
        qgemm_id_kernel(torch.zeros(32, 256, dtype=torch.bfloat16, device=dev), te, w, 32)
    with pytest.raises(ValueError):  # int64 ids
        qmv_id_kernel(xs[:2], torch.zeros(2, dtype=torch.int64, device=dev), w)
    with pytest.raises(ValueError):  # a 2-D weight
        qmv_id_kernel(xs[:2], te.repeat(2), random_wire("Q4_K", 64, 256, g, dev))
    with pytest.raises(ValueError):  # f32 x: the K10 route's job
        qgemm_id_kernel(xs.float(), te, w, 64)


@pytest.mark.parametrize("softcap,window", [(0.0, 0), (25.0, 0), (0.0, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_matches_plain(dev, softcap, window, dtype):
    L, B, S, H, Hkv, D = 2, 2, 512, 8, 2, 64
    g = torch.Generator(device=dev).manual_seed(1)

    def rnd(*s):
        return torch.randn(*s, generator=g, device=dev).to(dtype)

    ks, vs = rnd(L, B, S, Hkv, D), rnd(L, B, S, Hkv, D)
    q, kc, vc = rnd(B, H, D), rnd(B, Hkv, D), rnd(B, Hkv, D)
    seq_len = torch.tensor([300, 17], dtype=torch.int32, device=dev)
    for il in range(L):
        got = flash_decode_stacked_dense(q, ks, vs, il, kc, vc, seq_len, D**-0.5,
                                         softcap=softcap, window=window, kv_cap=384)
        ref = flash_decode_stacked_dense_plain(q, ks, vs, il, kc, vc, seq_len, D**-0.5,
                                               softcap=softcap, window=window, kv_cap=384)
        torch.cuda.synchronize()
        tol = 1e-5 if dtype == torch.float32 else 1e-2
        assert rel_err(got, ref) < tol


@pytest.mark.parametrize("softcap,window", [(0.0, 0), (25.0, 0), (0.0, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [1, 16, 37])
def test_flash_prefill_matches_plain(dev, softcap, window, dtype, T):
    B, S, H, Hkv, D = 2, 300, 8, 2, 64
    g = torch.Generator(device=dev).manual_seed(T)

    def rnd(*s):
        return torch.randn(*s, generator=g, device=dev).to(dtype)

    cache_k, cache_v = rnd(2, B, S + 20, Hkv, D), rnd(2, B, S + 20, Hkv, D)
    k, v = cache_k[1, :, :S], cache_v[1, :, :S]  # a strided layer view
    q, kc, vc = rnd(B, T, H, D), rnd(B, T, Hkv, D), rnd(B, T, Hkv, D)
    seq_len = torch.tensor([250, 0], dtype=torch.int32, device=dev)
    got = flash_prefill_kernel(q, k, v, kc, vc, seq_len, D**-0.5, softcap, window)
    ref = flash_prefill_attention_plain(q, k, v, kc, vc, seq_len, D**-0.5, softcap, window)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    assert rel_err(got, ref) < tol


def _quant_cache(dev, kinds, L, B, S, Hkv, D, g):
    """A QuantKVCache filled with quantized random K/V at every slot."""
    cache = QuantKVCache.create(L, B, S, Hkv, D, D, kinds=kinds, device=dev)
    k = torch.randn(L, B, S, Hkv, D, generator=g, device=dev)
    v = torch.randn(L, B, S, Hkv, D, generator=g, device=dev)
    return cache.write_all(k, v, torch.zeros(B, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kinds", KIND_PAIRS, ids=lambda p: f"{p[0]}-{p[1]}")
def test_flash_decode_quant_matches_plain(dev, kinds, dtype):
    L, B, S, H, Hkv, D = 2, 2, 512, 8, 2, 128
    g = torch.Generator(device=dev).manual_seed(3)
    cache = _quant_cache(dev, kinds, L, B, S, Hkv, D, g)
    q = torch.randn(B, H, D, generator=g, device=dev).to(dtype)
    kc = torch.randn(B, Hkv, D, generator=g, device=dev).to(dtype)
    vc = torch.randn(B, Hkv, D, generator=g, device=dev).to(dtype)
    seq_len = torch.tensor([300, 17], dtype=torch.int32, device=dev)
    for softcap, window, kv_cap in ((0.0, 0, None), (25.0, 64, 384)):
        args = (q, cache.k_planes, cache.v_planes, 1, kc, vc, seq_len, D**-0.5)
        kw = dict(softcap=softcap, window=window, kv_cap=kv_cap, kinds=kinds)
        got = flash_decode_quant_kernel(*args, **kw)
        ref = flash_decode_stacked_plain(*args, **kw)
        torch.cuda.synchronize()
        assert got.shape == (B, H, D) and got.dtype == dtype
        assert rel_err(got, ref) < ATTN_TOL[dtype]
    # the per-layer entry (K8a/K8b) on planes[il] views launches the same kernel
    before = build.LAUNCHES["flash_decode_quant"]
    got = flash_decode_q8(q, [p[1] for p in cache.k_planes], [p[1] for p in cache.v_planes],
                          kc, vc, seq_len, D**-0.5, kinds=kinds)
    assert build.LAUNCHES["flash_decode_quant"] == before + 1
    ref = flash_decode_stacked_plain(q, cache.k_planes, cache.v_planes, 1, kc, vc, seq_len,
                                     D**-0.5, kinds=kinds)
    assert rel_err(got, ref) < ATTN_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kinds", KIND_PAIRS, ids=lambda p: f"{p[0]}-{p[1]}")
def test_flash_prefill_quant_matches_plain(dev, kinds, dtype):
    B, S, T, H, Hkv, D = 2, 320, 37, 8, 2, 128
    g = torch.Generator(device=dev).manual_seed(4)
    cache = _quant_cache(dev, kinds, 2, B, S, Hkv, D, g)
    kp, vp = [p[1] for p in cache.k_planes], [p[1] for p in cache.v_planes]
    q = torch.randn(B, T, H, D, generator=g, device=dev).to(dtype)
    kc = torch.randn(B, T, Hkv, D, generator=g, device=dev).to(dtype)
    vc = torch.randn(B, T, Hkv, D, generator=g, device=dev).to(dtype)
    seq_len = torch.tensor([250, 0], dtype=torch.int32, device=dev)
    for softcap, window, kv_cap in ((0.0, 0, None), (25.0, 16, 256)):
        kw = dict(softcap=softcap, window=window, kv_cap=kv_cap, kinds=kinds)
        got = flash_prefill_quant_kernel(q, kp, vp, kc, vc, seq_len, D**-0.5, **kw)
        ref = flash_prefill_q8_plain(q, kp, vp, kc, vc, seq_len, D**-0.5, **kw)
        torch.cuda.synchronize()
        assert got.shape == (B, T, H, D) and got.dtype == dtype
        assert rel_err(got, ref) < ATTN_TOL[dtype]


def test_quant_launchers_reject_bad_input(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    cache = _quant_cache(dev, ("q8_0", "q4_0"), 1, 1, 64, 2, 64, g)
    q, cur = torch.zeros(1, 4, 64, device=dev), torch.zeros(1, 2, 64, device=dev)
    n = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):  # kinds do not match the planes
        flash_decode_quant_kernel(q, cache.k_planes, cache.v_planes, 0, cur, cur, n, 1.0,
                                  kinds=("q4_0", "q8_0"))
    with pytest.raises(ValueError):  # layer out of range
        flash_decode_quant_kernel(q, cache.k_planes, cache.v_planes, 1, cur, cur, n, 1.0,
                                  kinds=cache.kinds)


def test_random_wire_is_finite(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    for kind in BLOCK_BYTES:
        w = random_wire(kind, 64, 512, g, dev)
        assert isinstance(w, WireTensor)
        x = torch.ones(1, 512, device=dev)
        assert torch.isfinite(qmv(x, [w])[0]).all()
