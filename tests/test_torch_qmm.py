"""The port's plain fused dequant x matmul (ops/cuda/qmm.py, reached through
ops/linear.py on CPU tensors) against the JAX Pallas qmm kernels run in
interpret mode. Gate: nmse < 2e-4, as tests/test_pallas_qmm.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llamacog_tpu.gguf import GGMLType
from llamacog_tpu.ops.pallas.qmm import qmm, qmm_multi
from llamacog_tpu.quant import quantize
from llamacog_tpu.quant.planar import from_gguf
from llamacog_tpu_torch.ops import linear
from llamacog_tpu_torch.ops.cuda.qmm import qmm_plain, share_launch
from llamacog_tpu_torch.quant import wire
from llamacog_tpu_torch.utils.synthetic import random_wire

from .test_torch_arch_qwen import one_torch_thread  # noqa: F401 (an autouse fixture)

N, K = 256, 512


def nmse(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return ((a - b) ** 2).sum() / max((b**2).sum(), 1e-20)


def _pair(kind, n, k, seed):
    """The same GGUF blocks as a JAX planar QuantTensor and a port WireTensor."""
    t = getattr(GGMLType, kind)
    rng = np.random.default_rng(seed)
    raw = quantize(rng.standard_normal((n, k)).astype(np.float32).reshape(-1), t)
    qt = from_gguf(raw, t, (n, k))
    qt.planes = {name: jnp.asarray(v) for name, v in qt.planes.items()}
    return qt, wire.from_bytes(raw, t, (n, k))


def _random_pair(kind, n, k, seed):
    """_pair over random blocks (utils/synthetic.py::random_wire): the codebook
    kinds' quantizer takes tens of seconds at the 8B widths."""
    raw = random_wire(kind, n, k, torch.Generator().manual_seed(seed)).blocks.numpy().reshape(-1)
    t = getattr(GGMLType, kind)
    qt = from_gguf(raw, t, (n, k))
    qt.planes = {name: jnp.asarray(v) for name, v in qt.planes.items()}
    return qt, wire.from_bytes(raw, t, (n, k))


# the 1-2 bit and ternary kinds: their quantizer takes seconds a 65k
# weights, so their cases run over random blocks (every grid index, sign
# and trit byte is valid)
LOW_KINDS = ["IQ2_XXS", "IQ2_XS", "IQ1_S", "IQ1_M", "TQ1_0", "TQ2_0"]
IQ_KINDS = ["IQ4_NL", "IQ4_XS", "IQ3_XXS", "IQ3_S", "IQ2_S", *LOW_KINDS]
KINDS = ["Q4_K", "Q6_K", "Q8_0", "Q5_K", "Q4_0", "Q4_1", "Q5_0", "Q5_1", "Q2_K", "Q3_K", *IQ_KINDS]


def _any_pair(kind, n, k, seed):
    return (_random_pair if kind in LOW_KINDS else _pair)(kind, n, k, seed)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("batch,bf16", [(1, False), (8, False), (32, False), (32, True)])
def test_qmm_plain_matches_pallas(kind, batch, bf16):
    """B=32 in bf16 is the qgemm path (bf16 operands), the rest qmv's (f32)."""
    qt, wt = _any_pair(kind, N, K, seed=batch)
    x = np.random.default_rng(batch + 1).standard_normal((batch, K)).astype(np.float32)
    xt = torch.from_numpy(x)
    if bf16:
        xt = xt.to(torch.bfloat16)
        x = xt.float().numpy()  # both packages see the same rounded input
    ref = np.asarray(qmm(jnp.asarray(x, jnp.bfloat16 if bf16 else jnp.float32), qt,
                         interpret=True))
    got = qmm_plain(xt, wt)
    assert got.dtype == torch.float32 and got.shape == (batch, N)
    assert nmse(got.numpy(), ref) < 2e-4
    # ops/linear.py sends a CPU tensor to the same plain version
    lin = linear.qmatmul(xt, wt)
    assert torch.equal(lin, got.to(xt.dtype))


@pytest.mark.parametrize("kinds", [("Q4_K", "Q6_K"), ("Q4_K", "Q8_0", "Q8_0"), ("IQ2_S", "Q4_K"),
                                   ("IQ4_XS", "Q5_K"), ("IQ3_XXS", "Q8_0", "Q8_0"),
                                   ("IQ2_XXS", "Q4_K"), ("IQ2_XS", "IQ3_S"),
                                   ("IQ1_M", "Q4_K", "Q4_K"), ("TQ2_0", "Q8_0", "Q8_0")],
                         ids=lambda k: "+".join(k))
@pytest.mark.parametrize("batch", [1, 32])
def test_qmm_multi_plain_matches_pallas(batch, kinds):
    """Weights sharing x in one launch: a Q4_K_M layer's attn_qk + attn_v
    (Q4_K + Q6_K), an 8-expert Q4_K_M file's attn_q + attn_k + attn_v
    (Q4_K + Q8_0 + Q8_0), and the IQ presets' (IQ3_XXS's and IQ2_M's IQ2_S
    attn_qk + Q4_K attn_v, IQ4_XS's + Q5_K attn_v, an 8-expert IQ3_XS
    file's IQ3_XXS attn_q + Q8_0 attn_k, attn_v), and the 1-2 bit and
    ternary presets' (IQ2_XXS + Q4_K; IQ2_S below four query heads a kv
    head: IQ2_XS + IQ3_S; an 8-expert IQ1_M file: IQ1_M + Q4_K + Q4_K; an
    8-expert TQ2_0 file: TQ2_0 + Q8_0 + Q8_0)."""
    pairs = [_any_pair(kind, N // (1 + i), K, seed=11 + i) for i, kind in enumerate(kinds)]
    x = np.random.default_rng(13).standard_normal((batch, K)).astype(np.float32)
    refs = qmm_multi(jnp.asarray(x), [qt for qt, _ in pairs], interpret=True)
    outs = linear.qmatmul_multi(torch.from_numpy(x), [wt for _, wt in pairs])
    assert [o.shape for o in outs] == [(batch, wt.shape[0]) for _, wt in pairs]
    for got, ref in zip(outs, refs):
        assert nmse(got.numpy(), np.asarray(ref)) < 2e-4


def test_codebook_kinds_share_launches_with_a_q4_k_m_files_kinds_only():
    """The kernels compile a codebook kind beside Q4_K, Q6_K, Q8_0 and Q5_K
    only (csrc/common.cuh::KS_IQ): qmatmul_multi declines any other mix, and
    its caller's per-weight products are the same."""
    assert share_launch(["IQ2_S", "Q4_K"]) and share_launch(["IQ3_XXS", "Q8_0", "Q8_0"])
    assert share_launch(["Q3_K", "Q5_K"]) and share_launch(["IQ4_NL", "IQ3_S"])
    assert not share_launch(["IQ2_S", "Q3_K"]) and not share_launch(["Q4_0", "IQ4_XS"])
    _, wa = _random_pair("IQ2_S", 64, K, seed=1)
    _, wb = _random_pair("Q3_K", 32, K, seed=2)
    x = torch.randn(2, K, generator=torch.Generator().manual_seed(3))
    assert linear.qmatmul_multi(x, [wa, wb]) is None
    assert [o.shape for o in linear.qmatmul_multi(x, [wa])] == [(2, 64)]


def test_low_bit_kinds_share_launches_with_their_set_only():
    """The 1-2 bit and ternary kinds share a launch with a Q4_K_M file's
    kinds and IQ3_S (csrc/common.cuh::KS_IQ_LOW), never with another
    codebook kind or a kind of KS_ALL: qmatmul_multi declines those mixes."""
    assert share_launch(["IQ2_XXS", "Q4_K"]) and share_launch(["IQ2_XS", "IQ3_S"])
    assert share_launch(["IQ1_S", "Q8_0", "Q8_0"]) and share_launch(["TQ1_0", "IQ1_M", "Q5_K"])
    assert not share_launch(["IQ2_XXS", "Q2_K"]) and not share_launch(["IQ1_S", "IQ4_XS"])
    assert not share_launch(["TQ2_0", "IQ2_S"])
    _, wa = _random_pair("IQ2_XXS", 64, K, seed=1)
    _, wb = _random_pair("Q2_K", 32, K, seed=2)
    x = torch.randn(2, K, generator=torch.Generator().manual_seed(3))
    assert linear.qmatmul_multi(x, [wa, wb]) is None
    assert [o.shape for o in linear.qmatmul_multi(x, [wa])] == [(2, 64)]


def test_qmatmul_casts_back_to_activation_dtype():
    """f32 kernel output, then cast to x's dtype (the JAX cast points)."""
    _, wt = _pair("Q4_K", N, K, seed=5)
    x = torch.randn(3, K, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    out = linear.qmatmul(x, wt)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, qmm_plain(x, wt).to(torch.bfloat16))


def test_qmatmul_multi_declines_mismatched_k():
    _, wa = _pair("Q4_K", N, K, seed=1)
    _, wb = _pair("Q4_K", N, 2 * K, seed=2)
    assert linear.qmatmul_multi(torch.zeros(1, K), [wa, wb]) is None


# legacy kinds: block bytes, qs offset, qh offset (0: none), level bias,
# the level's own offset
LEGACY = {"Q4_0": (18, 2, 0, 16, 8), "Q4_1": (20, 4, 0, 16, 0), "Q5_0": (22, 6, 2, 32, 16),
          "Q5_1": (24, 8, 4, 32, 0)}


def _levels_scales(wt):
    """The qmv kernel's levels [N, K] (the raw levels plus a bias: Q4_K,
    Q4_0, Q4_1, Q2_K and Q3_K 16 + q, Q5_K, Q5_0 and Q5_1 32 + q, Q6_K
    64 + q; Q8_0 and the codebook kinds the signed levels) and, per part of
    its lane slice (Q4_K, Q5_K, IQ2_S, IQ2_XS and IQ1_M 16 weights, Q6_K,
    Q2_K and Q3_K 8, Q8_0, the legacy, the other codebook and the ternary
    kinds 32), the scale sc and
    offset mn [N, K / part] of wt's blocks with the bias folded into mn, in
    f32 as the kernel forms them."""
    b = wt.blocks.reshape(-1, wire.BLOCK_BYTES[wt.kind])
    n, k = wt.shape
    if wt.kind in IQ_KINDS:
        # the signed levels themselves, no bias, no offset; a part a scale
        # (IQ2_S, IQ2_XS, IQ1_M 16 weights, the others 32). IQ1_S's and
        # IQ1_M's kernel takes 8 level under scale / 8: every product and
        # sum is these times a power of two, the same rounding
        q, sc = wire.iq_levels(wt.kind, b)
        mn = torch.zeros_like(sc)
    elif wt.kind in LEGACY:
        # one part a 32-weight block: levels 16 + q (4-bit) or 32 + q (5-bit),
        # sc = d, the bias and the block's offset (-8 d, -16 d, +m) in mn
        size, qs_at, qh_at, bias, off = LEGACY[wt.kind]
        blk = b.reshape(-1, size)
        q = torch.cat([blk[:, qs_at:qs_at + 16] & 0xF, blk[:, qs_at:qs_at + 16] >> 4], dim=1)
        if qh_at:
            q = q | (wire._bits32(blk[:, qh_at:qh_at + 4]) << 4)
        sc = wire._f16_at(blk, 0).reshape(-1, 8)
        mn = (bias + off) * sc
        if size in (20, 24):  # Q4_1, Q5_1: + m
            mn = mn - wire._f16_at(blk, 2).reshape(-1, 8)
        q = q.reshape(-1, 256) + bias
    elif wt.kind in ("Q2_K", "Q3_K"):
        # parts of 8 (half a 16-weight sub-block), levels 16 + q (Q3_K: q the
        # 3-bit code, the level's -4 folded into mn = 20 dl)
        if wt.kind == "Q2_K":
            q = wire._crumbs(b[:, 16:80])
            dl = wire._f16_at(b, 80) * (b[:, 0:16] & 0xF).float()
            mn = 16.0 * dl + wire._f16_at(b, 82) * (b[:, 0:16] >> 4).float()
        else:
            hm = b[:, 0:32].reshape(-1, 1, 32)
            q = wire._crumbs(b[:, 32:96]) | (torch.cat([(hm >> s) & 1 for s in range(8)],
                                                       dim=1).reshape(-1, 256) << 2)
            dl = wire._f16_at(b, 108) * (wire._q3_scales(b[:, 96:108]).float() - 32.0)
            mn = 20.0 * dl
        sc, mn = dl.repeat_interleave(2, dim=1), mn.repeat_interleave(2, dim=1)
        q = q + 16
    elif wt.kind == "Q8_0":
        blk = b.reshape(-1, 34)
        q = blk[:, 2:34].contiguous().view(torch.int8).reshape(-1, 256)
        sc = wire._f16_at(blk, 0).reshape(-1, 8)
        mn = torch.zeros_like(sc)
    elif wt.kind == "Q5_K":
        d, dmin = wire._f16_at(b, 0), wire._f16_at(b, 2)
        sc, mn = wire._k4_scale_min(b[:, 4:16])
        qh = b[:, 16:48].reshape(-1, 1, 32)
        hb = torch.cat([(qh >> s) & 1 for s in range(8)], dim=1).reshape(-1, 256)
        qs = b[:, 48:176].reshape(-1, 4, 1, 32)
        q = torch.cat([qs & 0xF, qs >> 4], dim=2).reshape(-1, 256) | (hb << 4)
        sc = (d * sc.float()).repeat_interleave(2, dim=1)
        mn = (32.0 * sc + (dmin * mn.float()).repeat_interleave(2, dim=1))
        q = q + 32
    elif wt.kind == "Q4_K":
        d, dmin = wire._f16_at(b, 0), wire._f16_at(b, 2)
        sc, mn = wire._k4_scale_min(b[:, 4:16])
        qs = b[:, 16:144].reshape(-1, 4, 1, 32)
        q = torch.cat([qs & 0xF, qs >> 4], dim=2).reshape(-1, 256)
        sc = (d * sc.float()).repeat_interleave(2, dim=1)   # 8 sub-blocks of 32 -> parts of 16
        mn = (16.0 * sc + (dmin * mn.float()).repeat_interleave(2, dim=1))
        q = q + 16
    else:
        ql = b[:, 0:128].reshape(-1, 2, 2, 32)
        nib = torch.cat([ql & 0xF, ql >> 4], dim=2)
        qh = b[:, 128:192].reshape(-1, 2, 1, 32)
        hb = torch.cat([(qh >> s) & 3 for s in (0, 2, 4, 6)], dim=2)
        q = (nib.to(torch.int16) | (hb.to(torch.int16) << 4)).reshape(-1, 256)
        s16 = wire._f16_at(b, 208) * b[:, 192:208].contiguous().view(torch.int8).float()
        sc = s16.repeat_interleave(2, dim=1)                # 16 sub-blocks of 16 -> parts of 8
        mn = 96.0 * sc
        q = q + 64
    return q.float().reshape(n, k), sc.reshape(n, -1), mn.reshape(n, -1)


def qmv_folded(x, wt):
    """The qmv kernel's (csrc/qmv.cu) order of arithmetic in plain f32: per
    part of a sub-block, the dot of the biased levels with x, the part's
    scale applied to that sum, its offset (the bias folded in) against the
    part's sum of x: out = sum_parts sc * (q . x) - mn * sum(x)."""
    q, sc, mn = _levels_scales(wt)
    n, k = wt.shape
    part = k // sc.shape[1]
    xp = x.float().reshape(x.shape[0], -1, part)                    # [B, P, part]
    dots = torch.einsum("npk,bpk->bnp", q.reshape(n, -1, part), xp)  # [B, N, P]
    return (sc[None] * dots - mn[None] * xp.sum(-1)[:, None]).sum(-1)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("K", [4096, 14336])
def test_qmv_folded_order_within_tolerance(kind, K):
    """Evidence for qmv's tolerance (TOL_QMM = 1e-4 of the largest output in
    chip_smoke.py and the -m cuda tests) at the 8B layer widths: the folded
    order against qmm_plain (weights formed, then dotted) and against the
    Pallas kernel in interpret mode, f32 at B = 1 and 8 (the codebook kinds
    over random blocks)."""
    qt, wt = (_random_pair if kind in IQ_KINDS else _pair)(kind, 128, K, seed=K)
    for batch in (1, 8):
        x = np.random.default_rng(K + batch).standard_normal((batch, K)).astype(np.float32)
        got = qmv_folded(torch.from_numpy(x), wt)
        for ref in (qmm_plain(torch.from_numpy(x), wt).numpy(),
                    np.asarray(qmm(jnp.asarray(x), qt, interpret=True))):
            err = np.abs(got.numpy() - ref).max() / np.abs(ref).max()
            assert err < 1e-4, err


def test_gemm_dequant_fused_rounding_matches_plain():
    """The GEMM tile (csrc/qgemm_tile.cuh) forms Q4_K weights as
    fma(d*sc, 16 + q, -16 d*sc) - dmin*m and Q6_K weights as
    fma(d*sc, 64 + q, -96 d*sc): the exact product needs at most 23
    significant bits, so each weight rounds exactly as the plain dequant's
    (d*sc)*q - dmin*m and (d*sc)*(q - 32); Q5_K weights as
    fma(d*sc, 32 + q, -32 d*sc) - dmin*m (at most 23 bits too). FMA is
    modelled in f64 (exact for these operands) with one rounding to f32.
    The legacy and low-bit kinds' forms below hold the same way."""
    rng = np.random.default_rng(0)
    n = 50_000
    f32 = np.float32
    d = (rng.standard_normal(n) * 10.0 ** rng.uniform(-4, 1, n)).astype(np.float16).astype(f32)
    dmin = np.abs(rng.standard_normal(n) * 10.0 ** rng.uniform(-4, 1, n)).astype(np.float16).astype(f32)

    def fma(a, b, c):
        return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(f32)

    sc, m, q = (rng.integers(0, 64, n).astype(f32), rng.integers(0, 64, n).astype(f32),
                rng.integers(0, 16, n).astype(f32))
    dl, ml = d * sc, dmin * m
    np.testing.assert_array_equal(fma(dl, 16 + q, -16 * dl) - ml, dl * q - ml)
    s8, q6 = rng.integers(-128, 128, n).astype(f32), rng.integers(0, 64, n).astype(f32)
    dl6 = d * s8
    np.testing.assert_array_equal(fma(dl6, 64 + q6, -96 * dl6), dl6 * (q6 - 32))
    q5 = rng.integers(0, 32, n).astype(f32)
    np.testing.assert_array_equal(fma(dl, 32 + q5, -32 * dl) - ml, dl * q5 - ml)
    # the legacy kinds (d alone is the scale): Q4_0 fma(d, 16 + q, -24 d) =
    # (q - 8) d, Q5_0 fma(d, 32 + q, -48 d) = (q - 16) d, Q4_1 / Q5_1
    # fma(d, B + q, -B d) + m = q d + m
    m = dmin
    np.testing.assert_array_equal(fma(d, 16 + q, -24 * d), (q - 8) * d)
    np.testing.assert_array_equal(fma(d, 32 + q5, -48 * d), (q5 - 16) * d)
    np.testing.assert_array_equal(fma(d, 16 + q, -16 * d) + m, q * d + m)
    np.testing.assert_array_equal(fma(d, 32 + q5, -32 * d) + m, q5 * d + m)
    # Q2_K (4-bit scale, 2-bit code) as Q4_K; Q3_K fma(dl, 16 + v, -20 dl) =
    # dl (v - 4) with dl = d (sc - 32), v the 3-bit code
    sc4, q2 = rng.integers(0, 16, n).astype(f32), rng.integers(0, 4, n).astype(f32)
    dl2 = d * sc4
    np.testing.assert_array_equal(fma(dl2, 16 + q2, -16 * dl2) - ml, dl2 * q2 - ml)
    dl3, v = d * (sc - 32), rng.integers(0, 8, n).astype(f32)
    np.testing.assert_array_equal(fma(dl3, 16 + v, -20 * dl3), dl3 * (v - 4))
