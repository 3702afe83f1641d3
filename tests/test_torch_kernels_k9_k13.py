"""The int8 prefill GEMM (K13, csrc/qmm_i8.cu), its activation quantization
kernel, and the per-layer dense decode entry (K9, the flash_decode_dense
kernel on one layer) against their plain PyTorch versions, on the card.

Every test needs an NVIDIA GPU (and nvcc): they carry the `cuda` marker and
skip where none is present. Run them on the card with
`python -m pytest --noconftest tests/test_torch_kernels_k9_k13.py -m cuda`
(this file imports no JAX). Tolerances, relative to the largest
|reference|: K13 takes the plain version's integer products and its f32
combine operation for operation, so it is expected to agree bit for bit
(K13_TOL 1e-6; the tile-height tests ask torch.equal); the quantize kernel
is bit-equal to quantize_activations; K9 as the dense attention kernels
(ATTN_TOL).
"""

import pytest
import torch

from llamacog_tpu_torch.ops import linear
from llamacog_tpu_torch.ops.cuda import build
from llamacog_tpu_torch.ops.cuda.flash_decode import (
    flash_decode_attention_plain, flash_decode_kernel)
from llamacog_tpu_torch.ops.cuda.flash_q8 import flash_decode_stacked_dense
from llamacog_tpu_torch.ops.cuda.qmm_i8 import (
    qmm_i8, qmm_i8_kernel, qmm_i8_plain, qmm_i8_tile_rows, quantize_activations,
    quantize_kernel)
from llamacog_tpu_torch.quant import mmq
from llamacog_tpu_torch.quant.wire import WireTensor
from llamacog_tpu_torch.utils.synthetic import random_wire

K13_TOL = 1e-6
ATTN_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain K13 multiplies in f32
    return torch.device("cuda")


def rel_err(got, ref):
    got, ref = got.double(), ref.double()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def _planes(kind, n, k, g, dev):
    w = random_wire(kind, n, k, g, dev)
    qi8, ws8T = mmq.build_mmq_planes(w)
    return WireTensor(w.kind, w.shape, w.blocks, qi8, ws8T)


@pytest.mark.parametrize("B,N,K", [(256, 512, 1024), (300, 256, 1024), (1, 256, 512),
                                   (130, 768, 2048), (513, 1024, 512)])
def test_qmm_i8_matches_plain(dev, B, N, K):
    """Ragged rows (B not a multiple of the 128-row tile) and N not a
    multiple of the 128-column tile (768 is)."""
    g = torch.Generator(device=dev).manual_seed(B + N)
    w = _planes("Q4_K", N, K, g, dev)
    xq, xs = quantize_activations(torch.randn(B, K, generator=g, device=dev))
    got = qmm_i8_kernel(xq, xs, w.qi8, w.ws8T)
    ref = qmm_i8_plain(xq, xs, w.qi8, w.ws8T)
    torch.cuda.synchronize()
    assert got.shape == (B, N) and rel_err(got, ref) <= K13_TOL


@pytest.mark.parametrize("B,N,K", [(300, 1024, 1024), (129, 768, 512), (512, 5120, 1024),
                                   (7, 130, 512), (513, 256, 2048)])
def test_qmm_i8_tile_heights_bit_equal(dev, B, N, K):
    """Both tile heights (64 and 128 weight rows) and the grid rule's choice
    at the ragged edges they produce: B past the 128-row activation tile,
    N past both tile heights (130), bit for bit."""
    g = torch.Generator(device=dev).manual_seed(B * N)
    w = _planes("Q4_K", N, K, g, dev) if N % 256 == 0 else None
    if w is None:  # the plane filter takes N % 256 == 0: planes of another shape
        wq = random_wire("Q4_K", N, K, g, dev)
        wb = torch.randint(-127, 128, (N, K), generator=g, device=dev, dtype=torch.int8)
        ws = torch.rand(K // mmq.MMQ_KB, N, generator=g, device=dev) * 1e-2
        w = WireTensor(wq.kind, wq.shape, wq.blocks, wb, ws)
    xq, xs = quantize_activations(torch.randn(B, K, generator=g, device=dev))
    ref = qmm_i8_plain(xq, xs, w.qi8, w.ws8T)
    assert qmm_i8_tile_rows(B, N) in (64, 128)
    for rows in (0, 64, 128):
        got = qmm_i8_kernel(xq, xs, w.qi8, w.ws8T, tile_rows=rows)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), rows


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,K", [(1, 512), (7, 4096), (300, 4096), (512, 14336)])
def test_quantize_kernel_bit_equal(dev, dtype, B, K):
    """Ragged row counts, a row of zeros (scale 1), ties that round to even."""
    g = torch.Generator(device=dev).manual_seed(B + K)
    x = (torch.randn(B, K, generator=g, device=dev) * 3).to(dtype)
    x[-1] = 0
    x[0, :4] = torch.tensor([127.0, 63.5, -0.5, 1.5], device=dev).to(dtype)
    before = build.LAUNCHES["quantize_i8"]
    xq, xs = quantize_kernel(x)
    assert build.LAUNCHES["quantize_i8"] == before + 1
    rq, rs = quantize_activations(x)
    torch.cuda.synchronize()
    assert torch.equal(xq, rq) and torch.equal(xs, rs) and xs[-1].item() == 1.0


def test_quantize_kernel_refuses_bad_inputs(dev):
    x = torch.zeros(4, 512, device=dev)
    quantize_kernel(x)  # the valid call
    for bad in (x[:, :500], x.half(), x.reshape(-1), x[:0], x.cpu()):
        with pytest.raises(ValueError):
            quantize_kernel(bad)


def test_shared_quantization_one_launch(dev):
    """attn_qk and attn_v with planes through qmatmul_multi: one quantize
    launch, K13 for each, the results of per-weight qmatmul."""
    g = torch.Generator(device=dev).manual_seed(9)
    w1, w2 = _planes("Q4_K", 768, 1024, g, dev), _planes("Q6_K", 256, 1024, g, dev)
    x = torch.randn(mmq.MMQ_MIN_B, 1024, generator=g, device=dev).to(torch.bfloat16)
    build.reset_launches()
    outs = linear.qmatmul_multi(x, [w1, w2])
    assert build.LAUNCHES["quantize_i8"] == 1 and build.LAUNCHES["qmm_i8"] == 2
    assert build.LAUNCHES["qgemm"] == 0
    for o, w in zip(outs, (w1, w2)):
        assert torch.equal(o, linear.qmatmul(x, w))


def test_qmm_i8_route_counts_and_matches(dev):
    """qmatmul takes K13 at MMQ_MIN_B rows (one launch, no qgemm) and qgemm
    below; the entry on a bf16 x equals the plain version."""
    g = torch.Generator(device=dev).manual_seed(5)
    w = _planes("Q6_K", 512, 1024, g, dev)
    x = torch.randn(mmq.MMQ_MIN_B, 1024, generator=g, device=dev).to(torch.bfloat16)
    build.reset_launches()
    out = linear.qmatmul(x, w)
    assert build.LAUNCHES["qmm_i8"] == 1 and build.LAUNCHES["qgemm"] == 0
    linear.qmatmul(x[:16], w)
    assert build.LAUNCHES["qmm_i8"] == 1 and build.LAUNCHES["qgemm"] == 1
    xq, xs = quantize_activations(x)
    ref = qmm_i8_plain(xq, xs, w.qi8, w.ws8T).to(torch.bfloat16)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and rel_err(out, ref) <= 1e-2
    assert rel_err(qmm_i8(x, w), qmm_i8_plain(xq, xs, w.qi8, w.ws8T)) <= K13_TOL


def test_qmm_i8_refuses_bad_inputs(dev):
    xq = torch.zeros(4, 1024, dtype=torch.int8, device=dev)
    xs = torch.ones(4, 1, device=dev)
    qi = torch.zeros(256, 1024, dtype=torch.int8, device=dev)
    ws = torch.ones(2, 256, device=dev)
    qmm_i8_kernel(xq, xs, qi, ws)  # the valid call
    for args in ((xq.float(), xs, qi, ws),                       # dtype
                 (xq[:, :768], xs, qi[:, :768], ws),             # K not a multiple of 512
                 (xq, xs, qi[:255], ws[:, :255]),                # N odd
                 (xq, xs, qi, ws[:1]),                           # scale groups
                 (xq, xs.reshape(4), qi, ws),                    # xs [B]
                 (xq.t().contiguous().t(), xs, qi, ws),          # not contiguous
                 (torch.zeros(4 * 1024 + 1, dtype=torch.int8, device=dev)[1:].view(4, 1024),
                  xs, qi, ws)):                                  # misaligned
        with pytest.raises(ValueError):
            qmm_i8_kernel(*args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("softcap,window", [(0.0, 0), (30.0, 0), (0.0, 100)])
def test_flash_decode_matches_plain(dev, dtype, softcap, window):
    """B = 3 rows at seq_len 0, 77 and 1000 of a 1024-slot layer, read whole
    and as a kv_cap slice of 512 (a strided view); 8B heads."""
    g = torch.Generator(device=dev).manual_seed(11)
    B, S, H, Hkv, D = 3, 1024, 32, 8, 128
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev).to(dtype)  # noqa: E731
    q, k, v, kc, vc = rnd(B, H, D), rnd(B, S, Hkv, D), rnd(B, S, Hkv, D), rnd(B, Hkv, D), \
        rnd(B, Hkv, D)
    seq = torch.tensor([0, 77, 1000], dtype=torch.int32, device=dev)
    for cap in (S, 512):
        args = (q, k[:, :cap], v[:, :cap], kc, vc, seq, D ** -0.5)
        build.reset_launches()
        got = flash_decode_kernel(*args, softcap=softcap, window=window)
        assert build.LAUNCHES["flash_decode"] == 1 and build.LAUNCHES["flash_decode_dense"] == 0
        ref = flash_decode_attention_plain(*args, softcap=softcap, window=window)
        torch.cuda.synchronize()
        assert rel_err(got, ref) <= ATTN_TOL[dtype]


def test_flash_decode_is_the_stacked_kernel_on_one_layer(dev):
    """K9 on layer il of a stacked cache gives K4's output bit for bit."""
    g = torch.Generator(device=dev).manual_seed(12)
    L, B, S, H, Hkv, D = 3, 2, 256, 32, 8, 128
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)  # noqa: E731
    ks, vs, q, kc, vc = rnd(L, B, S, Hkv, D), rnd(L, B, S, Hkv, D), rnd(B, H, D), \
        rnd(B, Hkv, D), rnd(B, Hkv, D)
    seq = torch.tensor([200, 31], dtype=torch.int32, device=dev)
    for il in range(L):
        a = flash_decode_kernel(q, ks[il, :, :192], vs[il, :, :192], kc, vc, seq, 0.1)
        b = flash_decode_stacked_dense(q, ks, vs, il, kc, vc, seq, 0.1, kv_cap=192)
        torch.cuda.synchronize()
        assert torch.equal(a, b)


def test_flash_decode_refuses_bad_inputs(dev):
    q = torch.zeros(2, 8, 32, device=dev)
    kv = torch.zeros(2, 64, 2, 32, device=dev)
    cur = torch.zeros(2, 2, 32, device=dev)
    seq = torch.zeros(2, dtype=torch.int32, device=dev)
    flash_decode_kernel(q, kv, kv, cur, cur, seq, 1.0)  # the valid call
    wide = torch.zeros(2, 64, 2, 40, device=dev)
    for args in ((q, kv.transpose(1, 2).contiguous().transpose(1, 2), kv, cur, cur, seq),
                 (q, wide[..., :32], wide[..., :32], cur, cur, seq),       # head stride
                 (q, kv.to(torch.bfloat16), kv, cur, cur, seq),            # dtype
                 (q, kv, kv[:, :32], cur, cur, seq),                       # k/v lengths
                 (q, kv, kv, cur, cur, seq.long()),                        # seq_len dtype
                 (q[:, :7], kv, kv, cur, cur, seq)):                       # H % Hkv
        with pytest.raises(ValueError):
            flash_decode_kernel(*args, 1.0)
