"""The port's wire-format dequant (llamacog_tpu_torch/quant/wire.py) against
the JAX package's decoders, on blocks from llamacog_tpu.quant.quantize and
on random blocks; the port's copy of the IQ tables (quant/iq_tables.py)
against the JAX package's."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llamacog_tpu.gguf import GGMLType
from llamacog_tpu.quant import quantize
from llamacog_tpu.quant import decode_np
from llamacog_tpu.quant.decode_np import dequantize_tensor
from llamacog_tpu.quant.planar import decode, from_gguf
from llamacog_tpu_torch.quant import iq_tables, mmq, wire
from llamacog_tpu_torch.utils.synthetic import random_experts, random_wire

KINDS = ["Q4_K", "Q6_K", "Q8_0", "Q5_K", "Q4_0", "Q4_1", "Q5_0", "Q5_1", "Q2_K", "Q3_K",
         "IQ4_NL", "IQ4_XS", "IQ3_XXS", "IQ3_S", "IQ2_S", "IQ2_XXS", "IQ2_XS", "IQ1_S", "IQ1_M",
         "TQ1_0", "TQ2_0"]


def _blocks(kind, n, k, seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((n, k)).astype(np.float32)
    return quantize(w.reshape(-1), getattr(GGMLType, kind))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", [(8, 256), (64, 1024)])
def test_dequant_bit_exact_vs_decode_np(kind, shape):
    """Same f32 operations in the same order as decode_np -> identical bits.
    decode_np's Q3_K returns float64 (its level offset is a float64
    np.where); every value is an exact f32 product (d * (scale - 32) has at
    most 17 significant bits, times a level in -4..3), so it is compared
    as f32."""
    raw = _blocks(kind, *shape, seed=len(kind) + shape[0])
    t = getattr(GGMLType, kind)
    ref = dequantize_tensor(raw, t, shape)
    if kind == "Q3_K":
        assert np.array_equal(ref.astype(np.float32).astype(np.float64), ref)
        ref = ref.astype(np.float32)
    got = wire.dequantize(wire.from_bytes(raw, t, shape)).numpy()
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("kind", KINDS)
def test_dequant_bit_exact_vs_decode_np_on_random_blocks(kind):
    """Random code, index, sign and scale bytes (every grid index and sign
    byte is valid), small positive f16 superblock scales (random_wire):
    the same bits as decode_np."""
    shape = (48, 512)
    w = random_wire(kind, *shape, torch.Generator().manual_seed(len(kind)))
    ref = dequantize_tensor(w.blocks.numpy().reshape(-1), getattr(GGMLType, kind), shape)
    ref = ref.astype(np.float32)  # Q3_K: exact f32 values in float64 (above)
    got = wire.dequantize(w).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("kind", KINDS)
def test_dequant_equals_planar_decode(kind):
    """planar.decode forms each weight from the same f32 products
    (premultiplied d*sc planes, dmin*m mins) as the wire dequant, and XLA on
    the CPU does not contract the multiply-subtract into an FMA, so the two
    agree exactly: 0 ulp."""
    shape = (32, 512)
    raw = _blocks(kind, *shape, seed=7)
    t = getattr(GGMLType, kind)
    qt = from_gguf(raw, t, shape)
    qt.planes = {k: jnp.asarray(v) for k, v in qt.planes.items()}
    ref = np.asarray(decode(qt, jnp.float32))
    got = wire.dequantize(wire.from_bytes(raw, t, shape)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("kind", KINDS)
def test_dequantize_rows_matches_full_indexed(kind):
    shape = (40, 512)
    t = getattr(GGMLType, kind)
    wt = wire.from_bytes(_blocks(kind, *shape, seed=3), t, shape)
    idx = torch.tensor([[5, 0, 39], [7, 7, 12]])
    full = wire.dequantize(wt)
    got = wire.dequantize_rows(wt, idx)
    assert got.shape == (2, 3, 512)
    assert torch.equal(got, full[idx])
    assert torch.equal(wire.dequantize_rows(wt, idx, torch.bfloat16),
                       full[idx].to(torch.bfloat16))


@pytest.mark.parametrize("kind", ["Q4_K", "Q2_K", "IQ3_XXS", "IQ2_XXS", "IQ1_M", "TQ1_0"])
def test_keep_decoded_returns_the_same_dequant(kind):
    """A weight that keeps its plain dequant (wire.keep_decoded) gives the
    dequantizers' values bit for bit: the whole weight, rows of a table,
    experts of a stack, in f32 and bf16, after a move (.to), and after a
    caller wrote to a dequant it was given."""
    g = torch.Generator().manual_seed(len(kind))
    w, stack = random_wire(kind, 256, 512, g), random_experts(kind, 4, 8, 512, g)
    kw, ks = wire.keep_decoded(w), wire.keep_decoded(stack)
    assert kw.decoded is not None and wire.keep_decoded(kw) is kw
    idx, ids = torch.tensor([[5, 0, 23], [7, 7, 12]]), torch.tensor([3, 0, 3])
    for dtype in (torch.float32, torch.bfloat16):
        assert torch.equal(wire.dequantize(kw, dtype), wire.dequantize(w, dtype))
        assert torch.equal(wire.dequantize_rows(kw, idx, dtype),
                           wire.dequantize_rows(w, idx, dtype))
        assert torch.equal(wire.dequantize_experts(ks, ids, dtype),
                           wire.dequantize_experts(stack, ids, dtype))
    assert torch.equal(wire.dequantize(kw.to("cpu")), wire.dequantize(w))
    # each dequant is a new tensor: a caller that writes to it (the int8
    # planes' build divides in place) leaves the kept decode as it was
    for got, want in zip(mmq.build_mmq_planes(kw), mmq.build_mmq_planes(w)):
        assert torch.equal(got, want)
    wire.dequantize(kw).zero_()
    assert torch.equal(wire.dequantize(kw), wire.dequantize(w))


@pytest.mark.parametrize("kind, k", [("Q4_K", 512), ("Q5_0", 288)])
def test_plain_products_read_a_kept_decode_in_place(kind, k):
    """The plain products (qmv/qgemm's and the experts' gather and grouped
    GEMM) over a kept decode, which they read in place, equal those over the
    blocks bit for bit, and leave the kept decode as it was."""
    from llamacog_tpu_torch.ops.cuda.qmm import qmm_plain
    from llamacog_tpu_torch.ops.cuda.qmm_id import qmm_gather_plain, qmm_ragged_plain

    g = torch.Generator().manual_seed(7)
    w, stack = random_wire(kind, 64, k, g), random_experts(kind, 4, 32, k, g)
    kw, ks = wire.keep_decoded(w), wire.keep_decoded(stack)
    before = kw.decoded.clone(), ks.decoded.clone()
    for rows in (1, 16):  # the matvec's f32 operands, the GEMM's bf16-rounded ones
        x = torch.randn(rows, k, generator=g).to(torch.bfloat16)
        assert torch.equal(qmm_plain(x, kw), qmm_plain(x, w))
        ids = torch.tensor([3, 0, 3, 1] * 4)[:rows]
        xs = torch.randn(len(ids), k, generator=g).to(torch.bfloat16)
        assert torch.equal(qmm_gather_plain(xs, ids, ks), qmm_gather_plain(xs, ids, stack))
    tiles = torch.tensor([2, 0], dtype=torch.int32)
    xs = torch.randn(32, k, generator=g).to(torch.bfloat16)
    assert torch.equal(qmm_ragged_plain(xs, tiles, ks, 16), qmm_ragged_plain(xs, tiles, stack, 16))
    assert torch.equal(kw.decoded, before[0]) and torch.equal(ks.decoded, before[1])


def test_keep_decoded_refuses_a_decode_of_another_shape():
    w = random_wire("Q4_K", 8, 256, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="decoded"):
        wire.WireTensor(w.kind, w.shape, w.blocks, decoded=torch.zeros(8, 512))
    with pytest.raises(ValueError, match="decoded"):
        wire.WireTensor(w.kind, w.shape, w.blocks,
                        decoded=torch.zeros(8, 256, dtype=torch.bfloat16))


def test_fuse_rows_concatenates_blocks():
    t = GGMLType.Q4_K
    a = wire.from_bytes(_blocks("Q4_K", 16, 256, 1), t, (16, 256))
    b = wire.from_bytes(_blocks("Q4_K", 8, 256, 2), t, (8, 256))
    c = wire.from_bytes(_blocks("Q6_K", 8, 256, 3), GGMLType.Q6_K, (8, 256))
    fused = wire.fuse_rows([a, b])
    assert fused.shape == (24, 256)
    assert torch.equal(wire.dequantize(fused),
                       torch.cat([wire.dequantize(a), wire.dequantize(b)]))
    assert wire.fuse_rows([a, c]) is None  # mixed kinds stay separate


def test_unported_kind_raises():
    """A kind the port does not carry is refused by name: Q8_K, which
    neither package runs as a weight (it is llama.cpp's activation
    quantization for the K-quant dot products)."""
    with pytest.raises(NotImplementedError, match="Q8_K"):
        wire.from_bytes(np.zeros(292, np.uint8), GGMLType.Q8_K, (1, 256))


@pytest.mark.parametrize("kind", wire.IQ_LEVEL_KINDS)
def test_iq_levels_scale_to_the_dequant(kind):
    """iq_levels' form, which the kernels take: every weight is its part's
    scale times its level, one f32 product (the dequant bit for bit); the
    levels are integers of at most 127 in magnitude (the kernels' bytes
    128 + level), IQ1_S's and IQ1_M's eighths of one (the bytes 128 + 8 level
    under the scale / 8), and the parts are 16 or 32 weights."""
    w = random_wire(kind, 24, 512, torch.Generator().manual_seed(len(kind) + 1))
    levels, scales = wire.iq_levels(kind, w.blocks.reshape(-1, wire.BLOCK_BYTES[kind]))
    assert levels.shape == (48, 256) and scales.shape[1] in (8, 16)
    byte = levels * 8 if kind in ("IQ1_S", "IQ1_M") else levels
    assert torch.equal(byte, byte.round()) and byte.abs().max() <= 127
    got = scales.repeat_interleave(256 // scales.shape[1], dim=1) * levels
    assert torch.equal(got.view(torch.int32),
                       wire.dequantize(w).reshape(-1, 256).view(torch.int32))


def test_iq_tables_are_the_jax_package_copy():
    """The port's iq_grids.npz holds the arrays of the JAX package's, bit for
    bit, and its f32 tables are those decode_np builds from them."""
    with np.load(Path(decode_np.__file__).with_name("iq_grids.npz")) as z:
        ref = {k: z[k] for k in z.files}
    got = iq_tables.raw()
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and np.array_equal(got[k], ref[k]), k
    np.testing.assert_array_equal(iq_tables.tables()["kvalues"].numpy(), decode_np.KVALUES_IQ4NL)
    g = decode_np._grids()
    for name in ("iq3xxs", "iq3s", "iq2xxs", "iq2xs", "iq2s", "iq1s", "sign128", "sign256"):
        np.testing.assert_array_equal(iq_tables.tables()[name].numpy(), g[name])


def _parse_header(text: str) -> dict:
    """The arrays and word constants of a cuda_header() text as numpy."""
    out = {}
    for name, body in re.findall(r"(\w+)\[\d+\] = \{(.*?)\};", text, re.S):
        out[name] = np.array([int(v, 16) for v in re.findall(r"0x([0-9a-f]+)u", body)],
                             dtype=np.uint32)
    for name, v in re.findall(r"constexpr uint32_t (\w+) = 0x([0-9a-f]+)u;", text):
        out[name] = np.uint32(int(v, 16))
    return out


def test_iq_cuda_header_holds_the_tables():
    """The header the kernels compile (ops/cuda/build.py writes it) holds
    the npz's grids word for word (iq1s packed: 1 + level j in the low
    nibble of byte j, 1 + level 4 + j in its high nibble) and the IQ4 levels
    + 128; the sign byte the kernels compute from a 7-bit index (the index
    with its parity as bit 7, common.cuh::iq_ksigns) is ksigns_iq2xs."""
    parsed = _parse_header(iq_tables.cuda_header())
    raw = iq_tables.raw()
    for name, c_name in (("iq3xxs", "IQ3XXS_GRID"), ("iq3s", "IQ3S_GRID"), ("iq2s", "IQ2S_GRID"),
                         ("iq2xxs", "IQ2XXS_GRID"), ("iq2xs", "IQ2XS_GRID")):
        np.testing.assert_array_equal(parsed[c_name], raw[name].view(np.uint32).reshape(-1))
    w = parsed["IQ1S_GRID"][:, None] >> (8 * np.arange(4, dtype=np.uint32))
    nibbles = np.concatenate([w & 0xF, (w >> 4) & 0xF], axis=1).astype(np.int64) - 1
    np.testing.assert_array_equal(nibbles, raw["iq1s"].view(np.int8).reshape(-1, 8))
    x80 = np.array([parsed[f"IQ4NL_X80_{i}"] for i in range(4)], np.uint32).view(np.uint8)
    np.testing.assert_array_equal(x80.astype(np.int64) - 128, decode_np.KVALUES_IQ4NL)
    idx = np.arange(128)
    parity = np.bitwise_xor.reduce((idx[:, None] >> np.arange(7)) & 1, axis=1)
    np.testing.assert_array_equal(idx | (parity << 7), raw["ksigns"])
