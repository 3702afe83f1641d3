"""The port's wire-format dequant (llamacog_tpu_torch/quant/wire.py) against
the JAX package's decoders, on blocks from llamacog_tpu.quant.quantize."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llamacog_tpu.gguf import GGMLType
from llamacog_tpu.quant import quantize
from llamacog_tpu.quant.decode_np import dequantize_tensor
from llamacog_tpu.quant.planar import decode, from_gguf
from llamacog_tpu_torch.quant import wire

KINDS = ["Q4_K", "Q6_K", "Q8_0", "Q5_K", "Q4_0", "Q4_1", "Q5_0", "Q5_1", "Q2_K", "Q3_K"]


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
    """A kind the port does not carry is refused by name."""
    with pytest.raises(NotImplementedError, match="IQ4_NL"):
        wire.from_bytes(np.zeros(18 * 8, np.uint8), GGMLType.IQ4_NL, (1, 256))
