"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (and nvcc to build the kernels): they
carry the `cuda` marker and skip where no GPU is present. Run them on the
card with `python -m pytest tests/test_torch_kernels.py -m cuda`.
Tolerances, relative to the largest |reference| (QMM_TOL): qmv rounds no
value to a narrower type and differs from the plain version in the order
of its sums (the biased levels dotted with x in f32 FMAs per part of a
sub-block, the scale applied after, the offset and the bias folded against
the part's sum of x); qgemm forms every weight as the plain version does,
rounds it to bf16 as the plain version does, and differs in f32 summation
order; the attention kernels differ in summation
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
    choose_splits, flash_decode_q8, flash_decode_q8_tiled, flash_decode_quant_kernel,
    flash_decode_stacked, flash_decode_stacked_dense, flash_decode_stacked_dense_plain,
    flash_decode_stacked_plain, flash_prefill_q8_plain, flash_prefill_quant_kernel)
from llamacog_tpu_torch.ops.cuda.qmm import qgemm, qmm_multi_cuda, qmm_plain, qmv
from llamacog_tpu_torch.ops.cuda.qmm_id import (
    RAGGED_MAX_EXPERTS, RAGGED_MAX_TILES, RAGGED_TILE, qgemm_id_kernel, qmm_gather, qmm_gather_offset,
    qmm_gather_plain, qmm_ragged, qmm_ragged_plain, qmv_id_kernel)
from llamacog_tpu_torch.ops.cuda import qmm_id
from llamacog_tpu_torch.quant.wire import BLOCK_BYTES, WireTensor
from llamacog_tpu_torch.runtime.kv_cache import QuantKVCache
from llamacog_tpu_torch.utils.synthetic import random_experts, random_wire

QMM_TOL = 1e-4
# the quantized-KV kernels dequantize every element bit for bit as the plain
# version does: the same tolerances as the dense attention kernels
ATTN_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
KIND_PAIRS = [(k, k) for k in ("q8_0", "q4_0", "q4_1", "q5_0", "q5_1")] + [
    ("q8_0", "q5_1"), ("q5_0", "q4_1"), ("bf16", "q4_0"), ("q8_0", "f16")]
# weight kinds of the weight kernels (qmv, qgemm, qmv_id, qgemm_id): the
# Q4_K_M body and its more-bits layers, the Q8_0 / Q5_K attention weights of
# an 8-expert Q4_K_M file, the legacy and low-bit kinds of llama.cpp's
# other presets, the codebook kinds of its IQ presets, and the 1-2 bit and
# ternary kinds of its IQ2, IQ1 and TQ presets
WEIGHT_KINDS = ["Q4_K", "Q6_K", "Q8_0", "Q5_K", "Q4_0", "Q4_1", "Q5_0", "Q5_1", "Q2_K", "Q3_K",
                "IQ4_NL", "IQ4_XS", "IQ3_XXS", "IQ3_S", "IQ2_S", "IQ2_XXS", "IQ2_XS", "IQ1_S",
                "IQ1_M", "TQ1_0", "TQ2_0"]

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def rel_err(got, ref):
    got, ref = got.double(), ref.double()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("kind", WEIGHT_KINDS)
@pytest.mark.parametrize("B,dtype", [*[(b, torch.float32) for b in range(1, 10)],
                                     (33, torch.float32),
                                     *[(b, torch.bfloat16) for b in range(1, 9)]])
def test_qmv_matches_plain(dev, kind, B, dtype):
    """Every batch of the two instantiations (B = 1; B <= 8) in both
    activation types, and f32 past 8 rows (chunks of 8 by blockIdx.y)."""
    g = torch.Generator(device=dev).manual_seed(B)
    w = random_wire(kind, 200, 1024, g, dev)  # N not a multiple of the block rows
    x = torch.randn(B, 1024, generator=g, device=dev).to(dtype)
    got, = qmv(x, [w])
    torch.cuda.synchronize()
    assert rel_err(got, qmm_plain(x, w)) < QMM_TOL


@pytest.mark.parametrize("kind", WEIGHT_KINDS)
@pytest.mark.parametrize("N,K", [(1000, 256), (1000, 1024), (200, 2304), (8200, 512)])
@pytest.mark.parametrize("B", [9, 63, 64, 65, 127, 128, 129, 300, 512])
def test_qgemm_matches_plain(dev, kind, N, K, B):
    """Both tile heights over ragged row tiles: 64 rows at B <= 64 and
    while ceil(B / 64) x the 128-row weight blocks fit the SMs one each (every
    B at N <= 1000; at N = 8200, 65 blocks, B up to 128 on a 132-SM card),
    128 rows past that (N = 8200 from B = 129). N off every tile width, one
    superblock (K = 256: Q6_K rows then start off 16-byte boundaries) and an
    odd number of stages (K = 2304)."""
    g = torch.Generator(device=dev).manual_seed(B + N + K)
    w = random_wire(kind, N, K, g, dev)
    x = torch.randn(B, K, generator=g, device=dev).to(torch.bfloat16)
    before = build.LAUNCHES["qgemm"]
    got, = qgemm(x, [w])
    assert build.LAUNCHES["qgemm"] == before + 1
    torch.cuda.synchronize()
    assert got.shape == (B, N) and bool(torch.isfinite(got).all())
    assert rel_err(got, qmm_plain(x, w)) < QMM_TOL


@pytest.mark.parametrize("kinds", [("Q4_K", "Q6_K", "Q6_K", "Q4_K"),
                                   ("Q8_0", "Q5_K", "Q4_K", "Q8_0"),
                                   ("Q5_K", "Q8_0", "Q6_K", "Q5_K"),
                                   ("Q3_K", "Q5_K", "Q4_0", "Q2_K"),
                                   ("Q4_1", "Q5_0", "Q5_1", "Q6_K"),
                                   ("IQ2_S", "Q4_K", "IQ3_S", "IQ3_XXS"),
                                   ("IQ4_XS", "Q5_K", "IQ4_NL", "Q8_0"),
                                   ("IQ2_XXS", "Q4_K", "IQ1_S", "IQ3_S"),
                                   ("TQ1_0", "IQ2_XS", "IQ1_M", "TQ2_0")], ids="-".join)
@pytest.mark.parametrize("B,dtype", [(1, torch.bfloat16), (5, torch.float32),
                                     *[(b, torch.bfloat16) for b in (9, 33, 70, 130)]])
def test_four_mixed_descriptors_one_launch(dev, B, dtype, kinds):
    """Four weights of mixed kinds sharing x (K3): one launch of qmv (B <= 8
    or f32) or qgemm, counted once, every output as its own product; qgemm
    on 64-row tiles (B = 9, 33) and on 128-row tiles (70 weight blocks: B =
    70, and B = 130 over two row tiles)."""
    g = torch.Generator(device=dev).manual_seed(B)
    ws = [random_wire(kind, n, 512, g, dev) for kind, n in zip(kinds, (300, 72, 8200, 8))]
    x = torch.randn(B, 512, generator=g, device=dev).to(dtype)
    build.reset_launches()
    outs = qmm_multi_cuda(x, ws)
    counter = "qgemm" if dtype == torch.bfloat16 and B > 8 else "qmv"
    assert {k: v for k, v in build.LAUNCHES.items() if v} == {counter: 1}
    torch.cuda.synchronize()
    for got, w in zip(outs, ws):
        assert got.shape == (B, w.shape[0])
        assert rel_err(got, qmm_plain(x, w)) < QMM_TOL


@pytest.mark.parametrize("kinds", [("Q4_K", "Q6_K"), ("Q4_K", "Q8_0", "Q8_0"), ("Q3_K", "Q5_K"),
                                   ("Q2_K", "Q4_K"), ("IQ2_S", "Q4_K"), ("IQ4_XS", "Q5_K"),
                                   ("IQ3_XXS", "Q8_0", "Q8_0"), ("IQ2_XXS", "Q4_K"),
                                   ("IQ2_XS", "IQ3_S"), ("IQ1_M", "Q4_K", "Q4_K"),
                                   ("TQ2_0", "Q8_0", "Q8_0")], ids="-".join)
@pytest.mark.parametrize("B", [9, 33, 130])
def test_qgemm_multi_matches_plain(dev, B, kinds):
    """attn_qk + attn_v of a Q4_K_M layer; attn_q + attn_k + attn_v of an
    8-expert Q4_K_M file; attn_qk + attn_v of a Q3_K_M layer (layers 0-1)
    and of a Q2_K layer; the IQ presets' attn_qk + attn_v (IQ3_XXS and
    IQ2_M: IQ2_S + Q4_K; IQ4_XS: + Q5_K) and an 8-expert IQ3_XS file's
    attn_q + attn_k + attn_v; the 1-2 bit presets' (IQ2_XXS + Q4_K; IQ2_S
    below four query heads a kv head: IQ2_XS + IQ3_S; an 8-expert IQ1_M
    file: IQ1_M + Q4_K + Q4_K) and an 8-expert TQ2_0 file's."""
    g = torch.Generator(device=dev).manual_seed(B)
    ws = [random_wire(kind, n, 512, g, dev) for kind, n in zip(kinds, (160, 72, 72))]
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
    with pytest.raises(ValueError):  # no instantiation holds a codebook kind with Q3_K
        qmv(torch.zeros(1, 256, device=dev), [random_wire("IQ2_S", 64, 256, g, dev),
                                              random_wire("Q3_K", 64, 256, g, dev)])
    with pytest.raises(ValueError):  # nor a 1-2 bit kind with a codebook kind of KS_IQ
        qgemm(torch.zeros(9, 256, device=dev, dtype=torch.bfloat16),
              [random_wire("IQ1_S", 64, 256, g, dev), random_wire("IQ4_XS", 64, 256, g, dev)])


def _routing(routing, S, g, dev):
    """Expert ids of S rows over 8 experts: random, all on one expert, on
    two, or random with ids outside [0, 8) (-1 and 8, rows of zeros) mixed
    in."""
    if routing == "one":
        return torch.full((S,), 3, dtype=torch.int32, device=dev)
    if routing == "two":
        return torch.arange(S, dtype=torch.int32, device=dev) % 2 * 5
    ids = torch.randint(0, 8, (S,), generator=g, device=dev, dtype=torch.int32)
    if routing == "outside":
        ids[::3] = -1
        ids[1::5] = 8
    return ids


@pytest.mark.parametrize("kind", WEIGHT_KINDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 2, 8, 16, 32, 300])
@pytest.mark.parametrize("routing", ["random", "one", "two", "outside"])
def test_qmv_id_matches_plain(dev, kind, dtype, S, routing, monkeypatch):
    """K10 at a decode step's rows (1 to 32; 300: the f32 ragged route's
    count), skewed routing and ids outside the stack; N 200, and 203, which
    no block's rows divide; over 8 experts the rows of 16 and 32 are grouped
    by expert (one qmv_id_group launch), the others a block a row (one
    qmv_id launch), and both kernels are held on every case they take."""
    g = torch.Generator(device=dev).manual_seed(S)
    n = 200 if routing == "random" else 203
    w = random_experts(kind, 8, n, 1024, g, dev)
    x = torch.randn(S, 1024, generator=g, device=dev).to(dtype)
    ids = _routing(routing, S, g, dev)
    before = dict(build.LAUNCHES)
    got = qmm_gather(x, ids, w)
    counter = "qmv_id_group" if qmm_id.gather_groups(S, 8) else "qmv_id"
    assert {k: v - before[k] for k, v in build.LAUNCHES.items() if v != before[k]} == \
        {counter: 1}
    torch.cuda.synchronize()
    assert got.shape == (S, n) and rel_err(got, qmm_gather_plain(x, ids, w)) < QMM_TOL
    assert torch.equal(qmm_gather_offset(x, ids, w), got)  # K12: the same kernel
    outside = (ids < 0) | (ids >= 8)
    assert (got[outside] == 0).all()
    # each kernel on the same rows: the same bits (the grouping kernel takes
    # 2 to 32 rows)
    monkeypatch.setattr(qmm_id, "gather_groups", lambda S, n_exp: False)
    assert torch.equal(qmm_gather(x, ids, w), got)
    if 2 <= S <= qmm_id.GATHER_GROUP_MAX:
        monkeypatch.setattr(qmm_id, "gather_groups", lambda S, n_exp: True)
        assert torch.equal(qmm_gather(x, ids, w), got)


@pytest.mark.parametrize("kind", ["Q4_K", "Q6_K", "Q8_0", "Q5_0", "IQ4_XS", "IQ2_XXS",
                                  "TQ1_0"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qmv_id_row_independence(dev, kind, dtype):
    """A row's result does not depend on the rows beside it: each of 8 rows
    run alone (a pass of one row) against the same row inside a 32-row
    launch that groups it with others on its expert."""
    g = torch.Generator(device=dev).manual_seed(7)
    w = random_experts(kind, 8, 264, 2048, g, dev)
    x = torch.randn(32, 2048, generator=g, device=dev).to(dtype)
    ids = torch.randint(0, 4, (32,), generator=g, device=dev, dtype=torch.int32)
    full = qmm_gather(x, ids, w)
    for s in range(0, 32, 4):
        alone = qmm_gather(x[s:s + 1].contiguous(), ids[s:s + 1].contiguous(), w)
        torch.cuda.synchronize()
        assert rel_err(alone[0], full[s]) <= 1e-6, s
        assert torch.equal(alone[0], full[s]), s  # the fold is the same in both kernels


@pytest.mark.parametrize("n_exp", [8, 128])
def test_qmv_id_one_launch_at_32_rows(dev, n_exp):
    """A 32-row gather (a 4-slot server's step at top 8) is one K10 launch
    with nothing before it: over 8 experts the rows are grouped by expert
    inside the kernel (qmv_id_group), over 128 (where rows seldom share one)
    a block per row (qmv_id)."""
    g = torch.Generator(device=dev).manual_seed(32)
    w = random_experts("Q4_K", n_exp, 256, 2048, g, dev)
    x = torch.randn(32, 2048, generator=g, device=dev).to(torch.bfloat16)
    ids = torch.topk(torch.randn(4, n_exp, generator=g, device=dev), 8).indices.reshape(-1)
    ids = ids.to(torch.int32)
    build.reset_launches()
    got = qmm_gather(x, ids, w)
    counter = "qmv_id_group" if n_exp == 8 else "qmv_id"
    assert build.LAUNCHES == {**{k: 0 for k in build.LAUNCHES}, counter: 1}
    torch.cuda.synchronize()
    assert rel_err(got, qmm_gather_plain(x, ids, w)) < QMM_TOL


# tile -> expert maps: every expert, empty experts between used ones, one
# expert, and padding tiles (expert n_exp) past the last used one
TILE_MAPS = [[0, 1, 2, 3], [0, 0, 3, 3, 3, 4, 4], [2], [1, 3, 3, 4, 4, 4]]


@pytest.mark.parametrize("kind", WEIGHT_KINDS)
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


@pytest.mark.parametrize("kind", WEIGHT_KINDS)
@pytest.mark.parametrize("tokens", [128, 512])
def test_qgemm_id_model_tile_token_counts(dev, kind, tokens):
    """The grouped GEMM on moe_sort's layout at the model's token tile (16)
    for a 128- and a 512-token prefill at top-2 of 8 experts, expert 3 empty
    and expert 5 a single row; narrow weights (N 200, K 1024) so the plain
    version stays quick."""
    from llamacog_tpu_torch.models.llama import moe_sort

    g = torch.Generator(device=dev).manual_seed(tokens)
    w = random_experts(kind, 8, 200, 1024, g, dev)
    pool = torch.tensor([0, 1, 2, 4, 6, 7], device=dev)
    pick = torch.stack([torch.randperm(6, generator=g, device=dev)[:2] for _ in range(tokens)])
    ids = pool[pick]
    ids[0, 1] = 5 if int(ids[0, 0]) != 5 else 4
    ids = ids.reshape(-1).to(torch.int32)
    counts = torch.bincount(ids.long(), minlength=8).tolist()
    assert counts[3] == 0 and counts[5] == 1
    dest, te, s_pad = moe_sort(ids, 8, RAGGED_TILE)
    rows = torch.randn(ids.shape[0], 1024, generator=g, device=dev).to(torch.bfloat16)
    xs = torch.zeros(s_pad, 1024, dtype=torch.bfloat16, device=dev).index_copy_(0, dest, rows)
    before = build.LAUNCHES["qgemm_id"]
    got = qmm_ragged(xs, te, w, RAGGED_TILE)
    assert build.LAUNCHES["qgemm_id"] == before + 1
    ref = qmm_ragged_plain(xs, te, w, RAGGED_TILE)
    torch.cuda.synchronize()
    assert rel_err(got, ref) < QMM_TOL
    pad = (te >= 8).repeat_interleave(RAGGED_TILE)
    assert (got[pad] == 0).all()


def test_moe_launchers_reject_bad_input(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    w = random_experts("Q4_K", 4, 64, 256, g, dev)
    te = torch.zeros(1, dtype=torch.int32, device=dev)
    xs = torch.zeros(64, 256, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):  # the kernel's token tile is a multiple of 16
        qgemm_id_kernel(torch.zeros(24, 256, dtype=torch.bfloat16, device=dev), te, w, 24)
    with pytest.raises(ValueError, match="experts"):  # more experts than the kernel takes
        qgemm_id_kernel(xs[:16], te, random_experts("Q4_K", RAGGED_MAX_EXPERTS + 1, 16, 256, g,
                                                    dev), 16)
    with pytest.raises(ValueError):  # more tiles than the kernel's tile list holds
        n = RAGGED_MAX_TILES + 1
        qgemm_id_kernel(torch.zeros(16 * n, 256, dtype=torch.bfloat16, device=dev),
                        torch.zeros(n, dtype=torch.int32, device=dev), w, 16)
    with pytest.raises(ValueError):  # int64 ids
        qmv_id_kernel(xs[:2], torch.zeros(2, dtype=torch.int64, device=dev), w)
    with pytest.raises(ValueError):  # a 2-D weight
        qmv_id_kernel(xs[:2], te.repeat(2), random_wire("Q4_K", 64, 256, g, dev))
    with pytest.raises(ValueError):  # f32 x: the K10 route's job
        qgemm_id_kernel(xs.float(), te, w, 64)
    with pytest.raises(ValueError, match="WireTensor"):  # dense experts: the einsum route's
        qmv_id_kernel(xs[:2], te.repeat(2), torch.zeros(4, 64, 256, device=dev))


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
    """The split kernel (64-position splits here: choose_splits(512, 2, 2)
    and (384, 2, 2)) at B = 2 with unequal depths on both sides of split
    boundaries, whole and with window, softcap and a kv_cap bucket; one
    count a call (split and combine)."""
    L, B, S, H, Hkv, D = 2, 2, 512, 8, 2, 128
    assert choose_splits(S, B, Hkv)[1] == choose_splits(384, B, Hkv)[1] == 64
    g = torch.Generator(device=dev).manual_seed(3)
    cache = _quant_cache(dev, kinds, L, B, S, Hkv, D, g)
    q = torch.randn(B, H, D, generator=g, device=dev).to(dtype)
    kc = torch.randn(B, Hkv, D, generator=g, device=dev).to(dtype)
    vc = torch.randn(B, Hkv, D, generator=g, device=dev).to(dtype)
    for lens in ((300, 17), (64, 65), (128, 511), (0, 1)):
        seq_len = torch.tensor(lens, dtype=torch.int32, device=dev)
        for softcap, window, kv_cap in ((0.0, 0, None), (25.0, 64, 384)):
            args = (q, cache.k_planes, cache.v_planes, 1, kc, vc, seq_len, D**-0.5)
            kw = dict(softcap=softcap, window=window, kv_cap=kv_cap, kinds=kinds)
            before = build.LAUNCHES["flash_decode_quant"]
            got = flash_decode_stacked(*args, **kw)
            assert build.LAUNCHES["flash_decode_quant"] == before + 1
            ref = flash_decode_stacked_plain(*args, **kw)
            torch.cuda.synchronize()
            assert got.shape == (B, H, D) and got.dtype == dtype
            assert rel_err(got, ref) < ATTN_TOL[dtype], (lens, softcap, window, kv_cap)
    # the per-layer entries (K8a, K8b) on planes[il] views launch the same kernel
    seq_len = torch.tensor([300, 17], dtype=torch.int32, device=dev)
    ref = flash_decode_stacked_plain(q, cache.k_planes, cache.v_planes, 1, kc, vc, seq_len,
                                     D**-0.5, kinds=kinds)
    for entry in (flash_decode_q8, flash_decode_q8_tiled):
        before = build.LAUNCHES["flash_decode_quant"]
        got = entry(q, [p[1] for p in cache.k_planes], [p[1] for p in cache.v_planes],
                    kc, vc, seq_len, D**-0.5, kinds=kinds)
        assert build.LAUNCHES["flash_decode_quant"] == before + 1
        assert rel_err(got, ref) < ATTN_TOL[dtype]


@pytest.mark.parametrize("H,Hkv,D", [(32, 8, 128), (16, 1, 64), (8, 2, 96)])
@pytest.mark.parametrize("kinds", [("q8_0", "q8_0"), ("q4_0", "q5_1")],
                         ids=lambda p: f"{p[0]}-{p[1]}")
def test_flash_decode_quant_split_edges(dev, kinds, H, Hkv, D):
    """The 8B heads (rep 4) over a 2048-slot cache (16 splits of 128), rep
    16 (the spilling head group) and a head dim whose group count (3) does
    not divide 8: depths at and around split boundaries, bf16."""
    B, S = 2, 2048
    g = torch.Generator(device=dev).manual_seed(H + D)
    cache = _quant_cache(dev, kinds, 1, B, S, Hkv, D, g)
    q = torch.randn(B, H, D, generator=g, device=dev).to(torch.bfloat16)
    kc = torch.randn(B, Hkv, D, generator=g, device=dev).to(torch.bfloat16)
    vc = torch.randn(B, Hkv, D, generator=g, device=dev).to(torch.bfloat16)
    split_len = choose_splits(S, B, Hkv)[1]
    for lens in ((split_len, split_len + 1), (8 * split_len - 1, 1000), (2047, 2048)):
        seq_len = torch.tensor(lens, dtype=torch.int32, device=dev)
        for window in (0, 300):
            args = (q, cache.k_planes, cache.v_planes, 0, kc, vc, seq_len, D**-0.5)
            got = flash_decode_quant_kernel(*args, window=window, kinds=kinds)
            ref = flash_decode_stacked_plain(*args, window=window, kinds=kinds)
            torch.cuda.synchronize()
            assert rel_err(got, ref) < ATTN_TOL[torch.bfloat16], (lens, window)


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
