"""Per-layer head counts in the port (openelm, deci), held against the JAX
package.

OpenELM by the JAX package's oracle spec (tests/test_e2e_oracle.py::
ARCH_ORACLE_SPECS: one attn_qkv, per-head q/k rms norms, tied head; its
head counts uniform) and by tests/test_torch_arch_qwen.py::write_gguf with
per-layer arrays (3 layers of 4, 2 and 6 query heads over 2, 1 and 3 kv
heads, FFN widths 64, 128 and 96: the attn_qkv split by each layer's own
heads, the attention output flattened by them, each layer's K/V padded with
zero heads to the cache's 3). DeciLM by the JAX package's converter on
crafted Hugging Face weights (block_configs, as
tests/test_convert_oracle_rc.py crafts them): a GQA layer at 2 kv heads,
an attention-free layer, a "linear attention" layer without an FFN
(attn_output alone, its FFN a no-op), a GQA layer at 1 kv head. Both
attend through the masked path alone, at prefill and decode, over the
dense and the quantized cache (the JAX route: every flash predicate
refuses per-layer kv heads), each layer over its own first heads of the
cache. The f32 prefill logits within 1e-4 of max |logit| and 16 greedy
tokens equal, with the dense and the q8_0 cache; the decode step's logits
equal an eager forward's bit for bit; a context shift matches the JAX
engine's.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llamacog_tpu.models.loader import load_model as jax_load_model
from llamacog_tpu.utils.testing import make_tiny_arch_gguf
from llamacog_tpu_torch.models import llama
from llamacog_tpu_torch.models.config import ModelConfig
from llamacog_tpu_torch.models.loader import load_model
from llamacog_tpu_torch.ops.cuda import flash_decode, flash_prefill, flash_q8
from llamacog_tpu_torch.runtime.engine import Engine
from llamacog_tpu_torch.utils import synthetic

from .test_e2e_oracle import ARCH_ORACLE_SPECS
from .test_torch_arch_qwen import (PROMPT, TOL, check_same_run, load_both,
                                   synthetic_matches_file, write_gguf)
from .test_torch_arch_qwen import one_torch_thread  # noqa: F401 (an autouse fixture)

OPENELM = dict(arch="openelm", n_layer=3, n_embd=64, head_dim=16, n_head=[4, 2, 6],
               n_head_kv=[2, 1, 3], n_ff=[64, 128, 96], fused_qkv=True, qk_norm=True,
               tied=True, seed=4)
# (n_heads_in_group, replace_with_linear, ffn_mult): at hidden 64 ffn_mult 6.0
# is 256 wide, 7.5 is 512 (2 x mult x 64 / 3, rounded up to a multiple of 256)
DECI_BLOCKS = ((2, False, 6.0), (None, False, 7.5), (None, True, None), (4, False, 6.0))
E, NH, V = 64, 4, 256


def _deci_hf(d):
    """A crafted DeciLM checkpoint (config.json, model.safetensors and a
    stub tokenizer.json) of DECI_BLOCKS in directory d."""
    from safetensors.numpy import save_file

    hd = E // NH
    blocks = [{"attention": {"n_heads_in_group": g, "replace_with_linear": lin},
               "ffn": {"ffn_mult": m}} for g, lin, m in DECI_BLOCKS]
    cfg = dict(architectures=["DeciLMForCausalLM"], vocab_size=V, hidden_size=E,
               num_hidden_layers=len(blocks), num_attention_heads=NH, block_configs=blocks,
               max_position_embeddings=2048, rms_norm_eps=1e-5, rope_theta=10000.0)
    t = {"model.embed_tokens.weight": (V, E), "model.norm.weight": (E,),
         "lm_head.weight": (V, E)}
    for i, (g, lin, m) in enumerate(DECI_BLOCKS):
        p = f"model.layers.{i}"
        # the JAX forward norms every layer's input before it looks at the
        # layer's kind, so the attention-free layer keeps its norm too
        t[f"{p}.input_layernorm.weight"] = (E,)
        if g:
            t.update({f"{p}.self_attn.q_proj.weight": (NH * hd, E),
                      f"{p}.self_attn.k_proj.weight": (NH // g * hd, E),
                      f"{p}.self_attn.v_proj.weight": (NH // g * hd, E),
                      f"{p}.self_attn.o_proj.weight": (E, NH * hd)})
        elif lin:
            t[f"{p}.self_attn.linear_attn.weight"] = (E, E)
        if m is not None:
            f = int(2 * m * E / 3)
            f += (256 - f % 256) % 256
            t.update({f"{p}.post_attention_layernorm.weight": (E,),
                      f"{p}.mlp.gate_proj.weight": (f, E), f"{p}.mlp.up_proj.weight": (f, E),
                      f"{p}.mlp.down_proj.weight": (E, f)})
    d.mkdir()
    (d / "config.json").write_text(json.dumps(cfg))
    rng = np.random.default_rng(12)
    data = {}
    for k, shape in t.items():
        a = rng.standard_normal(shape).astype(np.float32) * 0.1
        data[k] = (1.0 + a) if k.endswith("norm.weight") else a
    save_file(data, str(d / "model.safetensors"))
    (d / "tokenizer.json").write_text(json.dumps({
        "model": {"type": "BPE", "vocab": {f"t{i}": i for i in range(V)}, "merges": []},
        "added_tokens": []}))
    return str(d)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from llamacog_tpu.tools.convert_hf import convert

    root = tmp_path_factory.mktemp("arch_per_layer_heads")
    out = {"openelm": make_tiny_arch_gguf(str(root / "openelm.gguf"), "openelm", seed=3,
                                          **ARCH_ORACLE_SPECS["openelm"]),
           "openelm per-layer": write_gguf(str(root / "openelm_pl.gguf"), **OPENELM),
           "deci": str(root / "deci.gguf")}
    convert(_deci_hf(root / "deci_hf"), out["deci"], outtype="f32")
    return out


@pytest.mark.parametrize("case,kv_type", [
    ("openelm", "dense"), ("openelm", "q8_0"), ("openelm per-layer", "dense"),
    ("openelm per-layer", "q8_0"), ("deci", "dense"), ("deci", "q8_0")])
def test_greedy_tokens_match_jax(files, case, kv_type):
    check_same_run(files[case], kv_type)


def test_deci_file_has_every_layer_kind(files):
    """The converted file's layers as the JAX loader keeps them: q/k/v of
    2 and 1 kv heads, no attention (layer 1), attn_output alone and no FFN
    (layer 2); the config's head arrays and the widest layer's cache."""
    m = load_model(files["deci"], dtype=torch.float32, device="cpu", with_tokenizer=False)
    ref = jax_load_model(files["deci"], with_tokenizer=False, dtype=jnp.float32)
    assert m.config.n_head_arr == ref.config.n_head_arr == (4, 0, 4, 4)
    assert m.config.n_head_kv_arr == ref.config.n_head_kv_arr == (2, 0, 0, 1)
    assert m.config.n_head_kv == 2
    layers = m.params["layers"]
    for lg, lr in zip(layers, ref.params["layers"]):
        assert set(lg) == set(lr)
    assert not {"attn_qkv", "attn_q", "attn_output"} & set(layers[1])
    assert "attn_output" in layers[2] and not {"ffn_gate_up", "ffn_up"} & set(layers[2])
    assert layers[0]["ffn_gate_up"].shape[0] == 512 and layers[1]["ffn_gate_up"].shape[0] == 1024


@pytest.mark.parametrize("case", ["openelm per-layer", "deci"])
def test_attention_takes_the_masked_route(files, case):
    """No flash route for a per-layer-head model over either cache
    (masked_only: the JAX predicates' n_head_kv_arr term); a prefill and a
    decode step leave each layer's padded heads of the cache zero."""
    m = load_model(files[case], dtype=torch.float32, device="cpu", with_tokenizer=False)
    assert flash_q8.masked_only(m.config)
    for kv_type in ("dense", "q8_0"):
        eng = Engine(m.params, m.config, max_seq=64, dtype=torch.float32, kv_type=kv_type,
                     device="cpu")
        cache = eng.cache
        assert not flash_q8.stacked_decode_supported(m.config, cache, 1)
        assert not flash_q8.decode_supported(m.config, cache, 1)
        assert not flash_q8.prefill_supported(m.config, cache)
        assert not flash_prefill.supported(m.config, cache)
        assert not flash_decode.supported(m.config, cache, 1)
        eng.prefill(PROMPT)
        eng.decode_one([5])
        if kv_type == "dense":
            for il, hkv in enumerate(m.config.n_head_kv_arr):
                assert not eng.cache.k[il, 0, :13, hkv:].any(), il
                assert not eng.cache.v[il, 0, :13, hkv:].any(), il


@pytest.mark.parametrize("case", ["openelm per-layer", "deci"])
def test_decode_step_logits_equal_an_eager_forward(files, case):
    """The decode step (on the card the body its graph captures: the K/V
    padded to the cache's heads, each layer's first heads read) gives the
    logits of the same forward called eagerly at the same state, bit for
    bit, step after step."""
    m = load_model(files[case], dtype=torch.float32, device="cpu", with_tokenizer=False)
    engs = [Engine(m.params, m.config, batch_size=1, max_seq=64, dtype=torch.float32,
                   device="cpu") for _ in range(2)]
    for e in engs:
        e.prefill(PROMPT)
    step, eager = engs
    tok = 5
    for _ in range(4):
        n = int(eager.seq_len[0])
        want = eager._step(torch.tensor([[tok]]), eager._dev_i32([n]), 1,
                           kv_cap=eager._kv_cap(n + 1))[0, 0]
        eager.seq_len[0] += 1
        got = step.decode_one([tok])[0]
        assert torch.equal(torch.from_numpy(got), want)
        tok = int(want.argmax())


@pytest.mark.parametrize("case", ["openelm per-layer", "deci"])
@pytest.mark.parametrize("kv_type", ["dense", "q8_0"])
def test_context_shift_matches_jax(files, case, kv_type):
    """shift_row on a cache of padded heads (a padded head stays zero under
    the rotation) and the decode steps after it equal the JAX engine's."""
    ref, eng, _ = load_both(files[case], batch_size=1, max_seq=256, kv_type=kv_type)
    ref.prefill(PROMPT)
    eng.prefill(PROMPT)
    ref.shift_row(0, 3, 5)
    eng.shift_row(0, 3, 5)
    tok = 9
    for _ in range(3):
        want = np.asarray(ref.decode_one(np.array([tok])))
        got = eng.decode_one(np.array([tok]))
        assert np.abs(got - want).max() <= TOL * np.abs(want).max()
        tok = int(np.argmax(want))


def test_the_synthetic_configs_are_admitted_and_refusals_stay():
    """OpenELM-3B (36 layers: 12 to 24 query heads over 3 to 6 kv heads,
    FFN 1536 to 12288) and the Nemotron-51B-wide deci pattern (every layer
    kind) are admitted; per-layer heads stay refused outside openelm and
    deci by name."""
    cfg = synthetic.openelm_3b_config()
    llama.check_supported(cfg)
    assert (min(cfg.n_head_arr), max(cfg.n_head_arr)) == (12, 24)
    assert (min(cfg.n_head_kv_arr), max(cfg.n_head_kv_arr)) == (3, 6)
    widths = cfg.metadata["openelm.feed_forward_length"]
    assert (widths[0], widths[-1]) == (1536, 12288)
    deci = synthetic.deci_51b_config(n_layer=6)
    llama.check_supported(deci)
    kinds = synthetic.tensor_kinds(deci, "Q4_K_M")["layers"]
    assert "attn_q" in kinds[0] and "attn_output" not in kinds[2]
    assert set(kinds[3]) & {"attn_q", "attn_output"} == {"attn_output"}
    assert "ffn_down" not in kinds[4]
    for name in ("gpt-j-6b", "chameleon-7b", "glm4-9b-0414"):
        base = synthetic.CONFIGS[name](n_layer=2)
        with pytest.raises(NotImplementedError, match="per-layer head counts"):
            llama.check_supported(ModelConfig(**{**base.__dict__, "n_head_kv_arr": (2, 2)}))


_SYNTH = {"openelm": dict(arch="openelm", n_layer=3, head_dim=64, n_head=[2, 3, 4],
                          n_head_kv=[1, 1, 2], n_ff=[256, 512, 768], fused_qkv=True,
                          qk_norm=True, tied=True),
          "deci": dict(arch="deci", n_layer=6, head_dim=64, n_head=[4, 4, 0, 4, 4, 4],
                       n_head_kv=[2, 1, 0, 0, 0, 2], n_ff=[512, 256, 512, 256, 0, 256])}


@pytest.mark.parametrize("case", sorted(_SYNTH))
def test_synthetic_params_are_a_loaded_file(tmp_path, case):
    """make_synthetic_params at each geometry is its Q4_K_M file loaded:
    OpenELM's attn_qkv, q/k norms and FFN widths by layer; deci's GQA,
    attention-free, linear-attention and FFN-free layers (attn_v counted
    by the attention layers alone, as llama.cpp's quantizer counts them)."""
    geo = dict(_SYNTH[case], n_embd=256)
    synthetic_matches_file(tmp_path, geo)


def test_attention_free_layer_without_attn_norm_fails_in_both(files):
    """An attention-free deci layer without attn_norm (as a Nemotron-51B file
    whose skipped attention has no input_layernorm holds it): the JAX
    forward norms every layer's input before it looks at the layer's kind
    and raises KeyError; the port refuses the layer by name."""
    from llamacog_tpu.runtime.engine import Engine as JaxEngine

    ref = jax_load_model(files["deci"], with_tokenizer=False, dtype=jnp.float32)
    del ref.params["layers"][1]["attn_norm"]
    with pytest.raises(KeyError, match="attn_norm"):
        JaxEngine(ref.params, ref.config, batch_size=1, max_seq=64,
                  dtype=jnp.float32).prefill(PROMPT)
    m = load_model(files["deci"], dtype=torch.float32, device="cpu", with_tokenizer=False)
    del m.params["layers"][1]["attn_norm"]
    eng = Engine(m.params, m.config, max_seq=64, dtype=torch.float32, device="cpu")
    with pytest.raises(NotImplementedError, match="layer 1: an attention-free layer without"):
        eng.prefill(PROMPT)
