"""The llama-graph clones in the port (xverse, baichuan, internlm2, exaone,
orion, codeshell, qwen, plamo), held against the JAX package.

Tiny random GGUFs, 2 layers: xverse, codeshell, qwen and plamo by the JAX
package's own oracle specs (tests/test_e2e_oracle.py::ARCH_ORACLE_SPECS,
written by make_tiny_arch_gguf: xverse the llama graph; codeshell GPT-2's
block (layer norms, one biased attn_qkv, biases on every product, an
ungated GELU FFN) with NeoX rope; qwen, the first Qwen, one biased attn_qkv
and a feed_forward_length twice its tensors' width; plamo one attn_norm
feeding the attention and the FFN in parallel, no ffn_norm); baichuan,
internlm2, exaone and orion (layer norms with their biases) by
tests/test_torch_arch_qwen.py::write_gguf, and a Q8_0 qwen file at the
quirk's widths. baichuan, internlm2 and xverse rotate interleaved pairs
(config.py's _ROPE_NORM_ARCHES), the others NeoX pairs. The f32 prefill
logits within 1e-4 of max |logit| and 16 greedy tokens equal, with the
dense cache and, for internlm2 and the Q8_0 qwen, the q8_0 cache.
"""

import dataclasses

import pytest
import torch

import jax.numpy as jnp

from llamacog_tpu.gguf import GGMLType
from llamacog_tpu.models.config import ModelConfig as JaxConfig
from llamacog_tpu.models.loader import load_model as jax_load_model
from llamacog_tpu.utils.testing import make_tiny_arch_gguf
from llamacog_tpu_torch.models import llama
from llamacog_tpu_torch.models.config import ModelConfig
from llamacog_tpu_torch.models.loader import load_model
from llamacog_tpu_torch.utils import synthetic

from .test_torch_arch_qwen import check_same_run, synthetic_matches_file, write_gguf
from .test_torch_arch_qwen import one_torch_thread  # noqa: F401 (an autouse fixture)

# tests/test_e2e_oracle.py::ARCH_ORACLE_SPECS
SPECS = {
    "xverse": dict(),
    "qwen": dict(qkv="fused", qkv_bias=True, n_head_kv=4, n_ff_meta=192),
    "plamo": dict(ffn_norm=False),
    "codeshell": dict(norm="layer", norm_bias=True, qkv="fused", qkv_bias=True, o_bias=True,
                      gate=False, ffn_bias=True),
}
CASES = {
    "baichuan": dict(arch="baichuan", n_head_kv=4),
    "internlm2": dict(arch="internlm2"),
    "exaone": dict(arch="exaone", metadata={"exaone.rope.freq_base": 500000.0}),
    "orion": dict(arch="orion", n_head_kv=4, norm_bias=True),
    # Qwen-1's widths in small: ffn_gate/ffn_up of 256 rows under a
    # feed_forward_length of 512, every product Q8_0
    "qwen Q8_0": dict(arch="qwen", n_embd=256, n_head_kv=4, n_ff=256, fused_qkv=True,
                      biases=("attn_qkv",), kind=lambda n: GGMLType.Q8_0,
                      metadata={"qwen.feed_forward_length": 512}),
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("arch_clones")
    out = {name: write_gguf(str(root / f"{name.replace(' ', '_')}.gguf"), **case)
           for name, case in CASES.items()}
    for arch, spec in SPECS.items():
        out[arch] = make_tiny_arch_gguf(str(root / f"{arch}.gguf"), arch, seed=17, **spec)
    return out


@pytest.mark.parametrize("case,kv_type", [
    ("xverse", "dense"), ("baichuan", "dense"), ("internlm2", "dense"), ("internlm2", "q8_0"),
    ("exaone", "dense"), ("orion", "dense"), ("codeshell", "dense"), ("qwen", "dense"),
    ("qwen Q8_0", "dense"), ("qwen Q8_0", "q8_0"), ("plamo", "dense")])
def test_clone_tokens_match_jax(files, case, kv_type):
    check_same_run(files[case], kv_type)


def test_keys_and_config_follow_the_jax_loader(files):
    """The JAX loader's keys and the per-arch defaults: orion's and
    codeshell's layer norms with their biases, codeshell's biased products
    and ungated FFN, qwen's biased attn_qkv and gate+up fused, plamo's
    parallel residual with no ffn_norm; interleaved rope on xverse,
    baichuan and internlm2 alone."""
    for case in (*SPECS, *CASES):
        ref = jax_load_model(files[case], with_tokenizer=False, dtype=jnp.float32)
        got = load_model(files[case], dtype=torch.float32, device="cpu", with_tokenizer=False)
        assert set(got.params) == set(ref.params), case
        assert set(got.params["layers"][0]) == set(ref.params["layers"][0]), case
        for f in ("norm_type", "ffn_act", "parallel_residual", "n_ff", "kq_scale"):
            assert getattr(got.config, f) == getattr(ref.config, f), (case, f)
        assert got.config.rope.interleaved == ref.config.rope.interleaved == (
            case in ("xverse", "baichuan", "internlm2")), case
    layers = {case: load_model(files[case], device="cpu", with_tokenizer=False).params["layers"][0]
              for case in ("orion", "codeshell", "qwen", "plamo")}
    assert {"attn_norm_b", "ffn_norm_b"} <= set(layers["orion"])
    assert {"attn_qkv_b", "attn_output_b", "ffn_up_b", "ffn_down_b"} <= set(layers["codeshell"])
    assert "ffn_gate" not in layers["codeshell"] and "ffn_gate_up" not in layers["codeshell"]
    assert {"attn_qkv", "attn_qkv_b", "ffn_gate_up"} <= set(layers["qwen"])
    assert "ffn_norm" not in layers["plamo"]


def test_qwen_products_are_sized_by_their_tensors(files):
    """Qwen-1's feed_forward_length is twice its ffn_gate/ffn_up rows: the
    loader keeps gate+up of 2 x 256 rows under n_ff 512 (no phi3-style
    split of a lone ffn_up), and the synthetic model's FFN is ffn_width
    wide."""
    m = load_model(files["qwen Q8_0"], device="cpu", with_tokenizer=False)
    cfg, layer = m.config, m.params["layers"][0]
    assert cfg.n_ff == 512 and synthetic.ffn_width(cfg) == 256
    assert layer["ffn_gate_up"].shape == (512, 256) and layer["ffn_down"].shape == (256, 256)
    syn = synthetic.make_synthetic_params(cfg, device="cpu", ftype="Q8_0")["layers"][0]
    assert syn["ffn_gate_up"].shape == (512, 256) and syn["ffn_down"].shape == (256, 256)
    assert synthetic.tensor_kinds(synthetic.qwen_7b_config(n_layer=2))["layers"][0] \
        ["ffn_down"] == "Q4_K"


def test_baichuan_13b_takes_rope_in_both_packages():
    """Fault 3.15: llama.cpp gives Baichuan-13B (40 layers) ALiBi and no
    rope (llm_build_baichuan); config.py gives every baichuan the llama
    graph with rope, whatever its depth, and the port keeps that parity:
    the 40-layer config of both packages has rope and no ALiBi."""
    md = {"general.architecture": "baichuan", "baichuan.embedding_length": 5120,
          "baichuan.block_count": 40, "baichuan.attention.head_count": 40,
          "baichuan.feed_forward_length": 13696, "baichuan.vocab_size": 125696}
    for cls in (JaxConfig, ModelConfig):
        cfg = cls.from_metadata(md)
        assert cfg.rope.enabled and not cfg.use_alibi
    llama.check_supported(ModelConfig.from_metadata(md))


def test_the_synthetic_configs_are_admitted():
    """check_supported admits the eight clones' configs at their published
    widths, and each runs the graph its arch's defaults give."""
    names = ("xverse-7b", "baichuan2-7b", "internlm2-7b", "exaone-3-7.8b", "orion-14b",
             "codeshell-7b", "qwen-7b", "plamo-13b")
    for name in names:
        cfg = synthetic.CONFIGS[name](n_layer=2)
        llama.check_supported(cfg)
        assert not cfg.use_alibi and cfg.rope.enabled
    assert synthetic.orion_14b_config().norm_type == "layer"
    assert synthetic.plamo_13b_config().parallel_residual
    assert synthetic.codeshell_7b_config().ffn_act == "gelu"
    # the archs outside the ported families (the encoders, the recurrent
    # models) stay refused
    for arch in ("bert", "nomic-bert", "t5", "mamba", "rwkv6"):
        with pytest.raises(NotImplementedError, match=f"architecture '{arch}' is not ported"):
            llama.check_supported(dataclasses.replace(synthetic.xverse_7b_config(2), arch=arch))


_SYNTH = {"xverse": dict(arch="xverse"), "baichuan": CASES["baichuan"],
          "internlm2": CASES["internlm2"], "exaone": dict(arch="exaone"),
          "orion": CASES["orion"],
          "codeshell": dict(arch="codeshell", fused_qkv=True, ffn_gate=False, norm_bias=True,
                            biases=("attn_qkv", "attn_output", "ffn_up", "ffn_down")),
          "qwen": {k: v for k, v in CASES["qwen Q8_0"].items() if k != "kind"},
          "plamo": dict(arch="plamo", ffn_norm=False)}


@pytest.mark.parametrize("case", sorted(_SYNTH))
def test_synthetic_params_are_a_loaded_file(tmp_path, case):
    """make_synthetic_params at each file's geometry is its Q4_K_M file
    loaded: orion's and codeshell's norm biases, codeshell's fused biased
    qkv and ungated FFN, qwen's biased attn_qkv and its FFN of half the
    feed_forward_length, plamo's missing ffn_norm."""
    geo = dict(_SYNTH[case], n_embd=256)
    if case != "qwen":
        geo["n_ff"] = 512
    synthetic_matches_file(tmp_path, geo)
