"""The port's attention (the plain versions of its decode and prefill
kernels, reached through the dispatch on CPU tensors) against the JAX
Pallas kernels run in interpret mode. f32 throughout; tolerances as the JAX
package's own kernel tests (tests/test_flash_q8.py, test_flash_prefill.py):
the two sides differ only in summation order and exp implementation."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llamacog_tpu.ops.pallas import flash_q8
from llamacog_tpu.ops.pallas.flash_prefill import flash_prefill_attention as jax_prefill
from llamacog_tpu_torch.ops.cuda.flash_prefill import flash_prefill_attention
from llamacog_tpu_torch.ops.cuda.flash_q8 import decode_from_cache
from llamacog_tpu_torch.runtime.kv_cache import KVCache

DECODE_ATOL = DECODE_RTOL = 2e-5
PREFILL_ATOL, PREFILL_RTOL = 5e-5, 1e-4


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("softcap", [0.0, 25.0])
@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("kv_cap", [None, 384])
def test_decode_matches_pallas_stacked_dense(softcap, window, kv_cap):
    L, B, S, H, Hkv, D = 2, 2, 512, 8, 2, 32
    rng = np.random.default_rng(3)
    k, v = _rand(rng, L, B, S, Hkv, D), _rand(rng, L, B, S, Hkv, D)
    q, kc, vc = _rand(rng, B, H, D), _rand(rng, B, Hkv, D), _rand(rng, B, Hkv, D)
    seq_len = np.array([300, 17], np.int32)
    cache = KVCache(torch.from_numpy(k), torch.from_numpy(v))
    for il in range(L):
        ref = flash_q8._flash_decode_stacked_dense(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), il, jnp.asarray(kc),
            jnp.asarray(vc), jnp.asarray(seq_len), D**-0.5, softcap=softcap, window=window,
            interpret=True, kv_cap=kv_cap)
        got = decode_from_cache(torch.from_numpy(q), cache, il, torch.from_numpy(kc),
                                torch.from_numpy(vc), torch.from_numpy(seq_len), D**-0.5,
                                softcap=softcap, window=window, kv_cap=kv_cap)
        assert got.shape == (B, H, D) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=DECODE_ATOL,
                                   rtol=DECODE_RTOL)


@pytest.mark.parametrize("softcap", [0.0, 25.0])
@pytest.mark.parametrize("window", [0, 16])
def test_prefill_matches_pallas(softcap, window):
    B, S, T, H, Hkv, D = 2, 1024, 16, 8, 2, 32
    rng = np.random.default_rng(4)
    k, v = _rand(rng, B, S, Hkv, D), _rand(rng, B, S, Hkv, D)
    q, kc, vc = _rand(rng, B, T, H, D), _rand(rng, B, T, Hkv, D), _rand(rng, B, T, Hkv, D)
    seq_len = np.array([600, 0], np.int32)
    ref = jax_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kc),
                      jnp.asarray(vc), jnp.asarray(seq_len), D**-0.5, softcap=softcap,
                      window=window, interpret=True)
    got = flash_prefill_attention(*(torch.from_numpy(a) for a in (q, k, v, kc, vc, seq_len)),
                                  D**-0.5, softcap=softcap, window=window)
    assert got.shape == (B, T, H, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=PREFILL_ATOL,
                               rtol=PREFILL_RTOL)
