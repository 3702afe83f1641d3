"""Phi-2 in the port (phi2), held against the JAX package, and the refusals
that stay in check_supported.

Tiny random GGUFs (tests/test_torch_arch_qwen.py::write_gguf): layer norms
with their biases, one attn_qkv with its bias, biases on the output
projection, on the ungated GELU FFN and on the LM head (output.bias), one
norm feeding the attention and the FFN in parallel, rope on 32 of each
head's 80 dims. The prefill logits within 1e-4 of
max |logit| and 16 greedy tokens equal, f32 models, with the dense and the
q8_0 cache; the bf16 prefill logits within 3e-2 of max |logit| (the bound
of tests/test_torch_model.py's bf16 test: the two frameworks round and sum
bf16 in other places).

Head dim 80: 32 does not divide it, so a quantized cache keeps each head
as one group (runtime/kv_cache.py), and K6/K7/K8 do not take it; the q8_0
cache reads through the masked path over the dequantized planes, the JAX
route (llamacog_tpu/ops/pallas/flash_q8.py:379-380,402-403,1044-1045). The
dense cache keeps K4/K5, which take 80 where the JAX decode route is
masked: a deliberate difference of route, not of result.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llamacog_tpu.models.loader import load_model as jax_load_model
from llamacog_tpu.ops.pallas import flash_q8 as jax_flash_q8
from llamacog_tpu.runtime.engine import Engine as JaxEngine
from llamacog_tpu.runtime.kv_cache import make_cache as jax_make_cache
from llamacog_tpu_torch.models import llama
from llamacog_tpu_torch.models.config import ModelConfig
from llamacog_tpu_torch.models.loader import load_model
from llamacog_tpu_torch.ops.cuda import flash_prefill, flash_q8
from llamacog_tpu_torch.runtime.engine import Engine
from llamacog_tpu_torch.runtime.kv_cache import make_cache
from llamacog_tpu_torch.utils import synthetic

from .test_torch_arch_qwen import PROMPT, check_same_run, synthetic_matches_file, write_gguf

TOL_BF16 = 3e-2  # of max |logit|, bf16 models (tests/test_torch_model.py)
PHI2 = dict(arch="phi2", n_embd=160, n_head=2, n_head_kv=2, head_dim=80, n_ff=256,
            fused_qkv=True, ffn_norm=False, ffn_gate=False, norm_bias=True,
            biases=("attn_qkv", "attn_output", "ffn_up", "ffn_down", "output"),
            metadata={"phi2.rope.dimension_count": 32})


@pytest.fixture(scope="module")
def phi2_file(tmp_path_factory):
    return write_gguf(str(tmp_path_factory.mktemp("arch_phi2") / "phi2.gguf"), **PHI2)


@pytest.mark.parametrize("kv_type", ["dense", "q8_0"])
def test_phi2_tokens_match_jax(phi2_file, kv_type):
    check_same_run(phi2_file, kv_type)


def bf16_prefill_close(path, kv_type="dense", max_seq=256):
    """The bf16 prefill logits of both packages within TOL_BF16 of max
    |logit| (shared with the other layer-norm families' tests)."""
    ref = jax_load_model(path, with_tokenizer=False, dtype=jnp.bfloat16)
    want = np.asarray(JaxEngine(ref.params, ref.config, batch_size=1, max_seq=max_seq,
                                dtype=jnp.bfloat16, kv_type=kv_type).prefill(PROMPT), np.float32)
    m = load_model(path, dtype=torch.bfloat16, device="cpu", with_tokenizer=False)
    got = Engine(m.params, m.config, batch_size=1, max_seq=max_seq, dtype=torch.bfloat16,
                 kv_type=kv_type, device="cpu").prefill(PROMPT)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= TOL_BF16 * np.abs(want).max()


def test_phi2_bf16_prefill_close_to_jax(phi2_file):
    bf16_prefill_close(phi2_file)


def test_keys_and_biases_follow_the_jax_loader(phi2_file):
    """The JAX loader's keys (attn_qkv with attn_qkv_b, attn_output_b,
    ffn_up/ffn_down with their biases and no ffn_gate or ffn_norm, the
    norm biases, output_b), the biases kept f32."""
    ref = jax_load_model(phi2_file, with_tokenizer=False, dtype=jnp.float32).params
    got = load_model(phi2_file, dtype=torch.bfloat16, device="cpu", with_tokenizer=False).params
    assert set(got) == set(ref) and "output_b" in got
    assert set(got["layers"][0]) == set(ref["layers"][0])
    assert {"attn_qkv_b", "attn_output_b", "ffn_up_b", "ffn_down_b", "attn_norm_b"} <= \
        set(got["layers"][0])
    assert not {"ffn_gate", "ffn_norm", "ffn_gate_up"} & set(got["layers"][0])
    for key in ("attn_qkv_b", "ffn_down_b", "attn_norm_b"):
        assert got["layers"][0][key].dtype == torch.float32
    assert got["output_b"].dtype == torch.float32


def test_attention_routes_at_head_dim_80(phi2_file, monkeypatch):
    """The q8_0 cache at head dim 80 takes the masked path at prefill and
    decode, as the JAX predicates rule (they refuse it too); the dense
    cache takes K5 and the stacked K4, where the JAX stacked predicate
    refuses D 80 (its decode is masked): the route differs, the result
    does not (test_phi2_tokens_match_jax)."""
    calls = {}
    for mod, name in ((flash_q8, "decode_from_cache"), (flash_q8, "flash_decode_q8_auto"),
                      (flash_q8, "flash_prefill_q8"), (flash_prefill, "flash_prefill_attention")):
        def counted(*a, _fn=getattr(mod, name), _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    m = load_model(phi2_file, dtype=torch.float32, device="cpu", with_tokenizer=False)
    for kv_type, want in (("q8_0", {}), ("dense", {"flash_prefill_attention": 2,
                                                   "decode_from_cache": 2 * 3})):
        calls.clear()
        eng = Engine(m.params, m.config, batch_size=1, max_seq=64, dtype=torch.float32,
                     kv_type=kv_type, device="cpu")
        eng.decode_greedy_tokens(np.array([int(np.argmax(eng.prefill(PROMPT)))]), 3)
        assert calls == want, kv_type
    # the predicates, with a head dim of 64 beside: the head dim decides
    jcfg = jax_load_model(phi2_file, with_tokenizer=False, dtype=jnp.float32).config
    for D in (80, 64):
        cfg, jc = (dataclasses.replace(c, head_dim_k=D, head_dim_v=D) for c in (m.config, jcfg))
        for kv_type, port_stacked in (("q8_0", D == 64), ("dense", True)):
            cache = make_cache(kv_type, 2, 1, 512, 2, D, D, device="cpu")
            jcache = jax_make_cache(kv_type, 2, 1, 512, 2, D, D)
            quant = kv_type == "q8_0" and D == 64
            assert jax_flash_q8.stacked_decode_supported(jc, jcache, 1) is (D == 64)
            assert flash_q8.stacked_decode_supported(cfg, cache, 1) is port_stacked
            assert jax_flash_q8.decode_supported(jc, jcache, 1) is quant
            assert flash_q8.decode_supported(cfg, cache, 1) is quant
            assert jax_flash_q8.prefill_supported(jc, jcache, 32, 512) is quant
            assert flash_q8.prefill_supported(cfg, cache) is quant


def test_synthetic_params_are_a_loaded_file(tmp_path):
    """make_synthetic_params at the Phi-2 file's geometry (160 wide: the
    32-weight-block fallback kinds) is that file in utils/synthetic.py's
    Q4_K_M kinds loaded: every bias, the norm biases, no ffn_norm."""
    synthetic_matches_file(tmp_path, PHI2)


def test_cli_runs_phi2(phi2_file, capsys):
    """tools/cli.py -m on a phi2 file: greedy text on the CPU."""
    from llamacog_tpu_torch.tools import cli

    assert cli.main(["-m", phi2_file, "--device", "cpu", "--dtype", "f32", "--greedy",
                     "-n", "8", "-p", "hello"]) == 0
    assert "decode: 8" in capsys.readouterr().err


# the archs that stay refused, each by its own name (none is admitted)
REFUSED_ARCHES = ("bert", "nomic-bert", "neo-bert", "t5", "jina-bert-v2", "nomic-bert-moe",
                  "rwkv6", "t5encoder", "jamba", "mamba")
# the features refused on an admitted arch, each set on a config that is
# admitted without it (the layer-norm families', and Llama-3's)
REFUSED_FEATURES = (("phi2", "use_alibi", True, "ALiBi"),
                    ("gpt2", "nonparam_norms", True, "non-parametric layer norm"),
                    ("falcon-7b", "post_norm_only", True, "post-norm-only layers"),
                    ("stablelm-2-1.6b", "residual_scale", 0.5, "residual scale"),
                    ("pythia-6.9b", "logit_scale", 0.5, "logit scale"),
                    ("starcoderbase-7b", "attn_clamp", 8.0, "clamp_kqv"),
                    ("phi2", "learned_pos_embd", True, "learned positions"),
                    ("starcoder2-7b", "parallel_residual", True, "parallel residual"),
                    ("llama3-8b", "norm_type", "layer", "layer norm"),
                    ("gpt-j-6b", "n_head_arr", (4, 4), "per-layer head counts"))


def test_remaining_refusals_by_name():
    """check_supported admits the eight layer-norm arches (each synthetic
    config at its published widths) and still refuses every other arch by
    its name, and each feature outside its families by the feature's
    name on an arch that is admitted."""
    for name in ("phi2", "falcon-7b", "falcon-40b", "gpt2", "stablelm-2-1.6b",
                 "starcoder2-7b", "starcoderbase-7b", "pythia-6.9b", "gpt-j-6b"):
        llama.check_supported(synthetic.CONFIGS[name](n_layer=2))
    base = synthetic.phi2_config(n_layer=2)
    for arch in REFUSED_ARCHES:
        with pytest.raises(NotImplementedError, match=f"architecture '{arch}' is not ported"):
            llama.check_supported(ModelConfig(**{**base.__dict__, "arch": arch}))
    for name, field, value, words in REFUSED_FEATURES:
        cfg = synthetic.CONFIGS[name](n_layer=2)
        llama.check_supported(cfg)
        with pytest.raises(NotImplementedError, match=words):
            llama.check_supported(ModelConfig(**{**cfg.__dict__, field: value}))
