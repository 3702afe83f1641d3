"""The port's per-layer decode routes against the JAX package: K9's plain
version (ops/cuda/flash_decode.py) against the Pallas kernel in interpret
mode, and f32 greedy tokens of the engine with LLAMACOG_FLASH_STACKED=0 —
the dense cache through K9 (LLAMACOG_FLASH_DECODE=1) or the masked path,
a q8_0 cache through K8 (flash_decode_q8_auto) or, with
LLAMACOG_FLASH_Q8=0, the masked path. Both packages read the routes from
the environment when their engine steps are built (JAX: at trace time), so
each engine is made after the variables are set."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llamacog_tpu.gguf import GGMLType
from llamacog_tpu.models import llama as jax_llama
from llamacog_tpu.models.loader import load_model as jax_load_model
from llamacog_tpu.ops.pallas import flash_decode as jax_flash_decode_mod
from llamacog_tpu.ops.pallas import flash_q8 as jax_flash_q8
from llamacog_tpu.ops.pallas.flash_decode import flash_decode_attention as jax_flash_decode
from llamacog_tpu.runtime.engine import Engine as JaxEngine
from llamacog_tpu.tools.quantize import main as quantize_main
from llamacog_tpu.utils.testing import make_tiny_llama_gguf
from llamacog_tpu_torch.models import llama
from llamacog_tpu_torch.models.loader import load_model
from llamacog_tpu_torch.ops.cuda import flash_decode, flash_q8
from llamacog_tpu_torch.runtime.engine import Engine
from llamacog_tpu_torch.runtime.kv_cache import KVCache, QuantKVCache
from llamacog_tpu_torch.utils.synthetic import llama3_8b_config

PROMPT = [3, 17, 9, 41, 200, 5, 77]
N_DECODE = 8


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_flash_decode_plain_matches_pallas(window, softcap):
    """B = 2 rows at seq_len 13 and 40 of S = 64; also a kv_cap slice (a
    strided view, as the forward passes it)."""
    B, S, H, Hkv, Dk, Dv = 2, 64, 8, 4, 16, 16
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, H, Dk), (B, S, Hkv, Dk), (B, S, Hkv, Dv)))
    kc, vc = (rng.standard_normal((B, Hkv, d)).astype(np.float32) for d in (Dk, Dv))
    seq_len = np.array([13, 40], np.int32)
    scale = Dk ** -0.5
    t = torch.from_numpy
    for cap in (S, 48):
        ref = np.asarray(jax_flash_decode(
            jnp.asarray(q), jnp.asarray(k[:, :cap]), jnp.asarray(v[:, :cap]), jnp.asarray(kc),
            jnp.asarray(vc), jnp.asarray(seq_len), scale, softcap=softcap, window=window,
            interpret=True))
        got = flash_decode.flash_decode_attention(
            t(q), t(k)[:, :cap], t(v)[:, :cap], t(kc), t(vc), t(seq_len), scale,
            softcap=softcap, window=window)
        assert got.shape == (B, H, Dv) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, atol=2e-6, rtol=1e-5)


def test_flash_decode_supported_predicate(monkeypatch):
    cfg = llama3_8b_config(n_layer=1)
    dense = KVCache.create(1, 1, 16, cfg.n_head_kv, 128, 128)
    quant = QuantKVCache.create(1, 1, 32, cfg.n_head_kv, 128, 128, kinds=("q8_0", "q8_0"))
    monkeypatch.delenv("LLAMACOG_FLASH_DECODE", raising=False)
    assert not flash_decode.supported(cfg, dense, 1)
    monkeypatch.setenv("LLAMACOG_FLASH_DECODE", "1")
    assert flash_decode.supported(cfg, dense, 1)
    assert not flash_decode.supported(cfg, dense, 2)
    assert not flash_decode.supported(cfg, quant, 1)


def test_flash_decode_kernel_refuses_cpu_tensors():
    q, kv, cur = torch.zeros(1, 4, 32), torch.zeros(1, 64, 2, 32), torch.zeros(1, 2, 32)
    with pytest.raises(ValueError, match="CUDA"):
        flash_decode.flash_decode_kernel(q, kv, kv, cur, cur, torch.zeros(1, dtype=torch.int32),
                                         1.0)


@pytest.fixture(scope="module")
def q4km_path(tmp_path_factory):
    d = tmp_path_factory.mktemp("q4km")
    src = str(d / "f32.gguf")
    make_tiny_llama_gguf(src, n_embd=256, n_head=4, n_head_kv=2, n_ff=512,
                         quant_type=GGMLType.F32)
    q = str(d / "q4km.gguf")
    assert quantize_main([src, q, "Q4_K_M"]) == 0
    return q


# (kv type, extra environment, the port's route: the function the forward
# calls for T = 1 attention)
ROUTES = [("dense", {"LLAMACOG_FLASH_DECODE": "1"}, "k9"),
          ("dense", {}, "masked"),
          ("q8_0", {}, "k8"),
          ("q8_0", {"LLAMACOG_FLASH_Q8": "0"}, "masked")]


@pytest.mark.parametrize("kv_type,env,route", ROUTES,
                         ids=[f"{kv}-{route}" for kv, _, route in ROUTES])
def test_per_layer_decode_greedy_tokens_match_jax(q4km_path, monkeypatch, kv_type, env, route):
    monkeypatch.setenv("LLAMACOG_FLASH_STACKED", "0")
    for name in ("LLAMACOG_FLASH_DECODE", "LLAMACOG_FLASH_Q8"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    calls = {"stacked": 0, "k8": 0, "k9": 0, "masked": 0}
    jax_calls = dict(calls)  # at trace time: once per layer and traced step

    def count(counts, module, attr, name):
        fn = getattr(module, attr)

        def wrapper(*a, **kw):
            counts[name] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(module, attr, wrapper)

    for counts, (fq8, fdec, model) in ((calls, (flash_q8, flash_decode, llama)),
                                       (jax_calls, (jax_flash_q8, jax_flash_decode_mod,
                                                    jax_llama))):
        count(counts, fq8, "decode_from_cache", "stacked")
        count(counts, fq8, "flash_decode_q8_auto", "k8")
        count(counts, fdec, "flash_decode_attention", "k9")
        count(counts, model, "masked_attention", "masked")

    mj = jax_load_model(q4km_path, with_tokenizer=False, dtype=jnp.float32)
    je = JaxEngine(mj.params, mj.config, batch_size=1, max_seq=512, dtype=jnp.float32,
                   kv_type=kv_type)
    ref_logits = np.asarray(je.prefill(PROMPT))
    ref_toks = np.asarray(je.decode_greedy_tokens(np.array([int(np.argmax(ref_logits))]),
                                                  N_DECODE))
    m = load_model(q4km_path, dtype=torch.float32, device="cpu", with_tokenizer=False)
    eng = Engine(m.params, m.config, batch_size=1, max_seq=512, dtype=torch.float32,
                 kv_type=kv_type, device="cpu")
    logits = eng.prefill(PROMPT)
    toks = eng.decode_greedy_tokens(np.array([int(np.argmax(logits))]), N_DECODE)
    np.testing.assert_allclose(logits, ref_logits, atol=2e-3, rtol=1e-3)
    np.testing.assert_array_equal(toks, ref_toks)
    n_calls = N_DECODE * m.config.n_layer  # one per layer and decode step
    assert calls == {name: (n_calls if name == route else 0) for name in calls}
    assert jax_calls["stacked"] == 0 and jax_calls[route] > 0
