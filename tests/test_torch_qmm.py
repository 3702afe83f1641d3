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
from llamacog_tpu_torch.ops.cuda.qmm import qmm_plain
from llamacog_tpu_torch.quant import wire

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


@pytest.mark.parametrize("kind", ["Q4_K", "Q6_K"])
@pytest.mark.parametrize("batch,bf16", [(1, False), (8, False), (32, False), (32, True)])
def test_qmm_plain_matches_pallas(kind, batch, bf16):
    """B=32 in bf16 is the qgemm path (bf16 operands), the rest qmv's (f32)."""
    qt, wt = _pair(kind, N, K, seed=batch)
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


@pytest.mark.parametrize("batch", [1, 32])
def test_qmm_multi_plain_matches_pallas(batch):
    """A Q4_K + Q6_K pair sharing x: the attn_qk + attn_v launch."""
    qa, wa = _pair("Q4_K", N, K, seed=11)
    qb, wb = _pair("Q6_K", N // 2, K, seed=12)
    x = np.random.default_rng(13).standard_normal((batch, K)).astype(np.float32)
    refs = qmm_multi(jnp.asarray(x), [qa, qb], interpret=True)
    outs = linear.qmatmul_multi(torch.from_numpy(x), [wa, wb])
    assert [o.shape for o in outs] == [(batch, N), (batch, N // 2)]
    for got, ref in zip(outs, refs):
        assert nmse(got.numpy(), np.asarray(ref)) < 2e-4


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
