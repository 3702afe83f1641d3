"""The GLM family in the port (glm4, chatglm), held against the JAX package.

Tiny random GGUFs (2 layers, n_embd 128, 8 query heads over one kv head of
16: GLM's many query heads a kv head) by tests/test_torch_arch_qwen.py::
write_gguf with llama.cpp's GLM tensors: the rope over half of each head
on interleaved pairs (the arch's "norm" rope type), one ffn_up of 2 x n_ff
rows holding [gate; up] (the JAX loader's row-count rule makes it
ffn_gate_up: SwiGLU, gate first), glm4's q/k/v apart with their biases and
its post-attention and post-FFN norms beside the pre-norms, chatglm's one
attn_qkv with its bias. The f32 prefill logits within 1e-4 of max |logit|
and 16 greedy tokens equal, with the dense and the q8_0 cache, and a glm4
file in Q8_0 (its biased q/k/v fuse into attn_qkv with the concatenated
biases).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llamacog_tpu.gguf import GGMLType
from llamacog_tpu.models.loader import load_model as jax_load_model
from llamacog_tpu_torch.models import llama
from llamacog_tpu_torch.models.config import ModelConfig
from llamacog_tpu_torch.models.loader import load_model
from llamacog_tpu_torch.utils import synthetic

from .test_torch_arch_qwen import check_same_run, synthetic_matches_file, write_gguf
from .test_torch_arch_qwen import one_torch_thread  # noqa: F401 (an autouse fixture)

GEO = dict(n_embd=128, n_head=8, n_head_kv=1, n_ff=192, fused_up=True)
CASES = {
    "glm4": dict(arch="glm4", qkv_bias=True, post_norms=True,
                 metadata={"glm4.rope.dimension_count": 8}, **GEO),
    "glm4 Q8_0": dict(arch="glm4", qkv_bias=True, post_norms=True, seed=2,
                      kind=lambda n: GGMLType.Q8_0, metadata={"glm4.rope.dimension_count": 8},
                      **{**GEO, "n_embd": 256, "n_ff": 256}),
    "chatglm": dict(arch="chatglm", fused_qkv=True, biases=("attn_qkv",), seed=1,
                    metadata={"chatglm.rope.dimension_count": 8,
                              "chatglm.rope.freq_base": 500000.0}, **GEO),
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("arch_glm")
    return {name: write_gguf(str(root / f"{name.replace(' ', '_')}.gguf"), **case)
            for name, case in CASES.items()}


@pytest.mark.parametrize("case,kv_type", [
    ("glm4", "dense"), ("glm4", "q8_0"), ("glm4 Q8_0", "dense"), ("chatglm", "dense"),
    ("chatglm", "q8_0")])
def test_greedy_tokens_match_jax(files, case, kv_type):
    check_same_run(files[case], kv_type)


def test_keys_and_config_follow_the_jax_loader(files):
    """The JAX loader's keys and config: the lone ffn_up of 2 x n_ff rows as
    ffn_gate_up; glm4's biased q/k/v apart in F32 (kinds agree: one
    attn_qkv with the concatenated biases) and its post-norms; chatglm's
    attn_qkv and its bias; interleaved rope over 8 of 16 dims."""
    want = {"glm4": {"attn_qkv", "attn_qkv_b", "ffn_gate_up", "attn_post_norm",
                     "ffn_post_norm", "attn_norm", "ffn_norm"},
            "glm4 Q8_0": {"attn_qkv", "attn_qkv_b", "ffn_gate_up"},
            "chatglm": {"attn_qkv", "attn_qkv_b", "ffn_gate_up", "attn_norm", "ffn_norm"}}
    for case, keys in want.items():
        ref = jax_load_model(files[case], with_tokenizer=False, dtype=jnp.float32)
        got = load_model(files[case], dtype=torch.float32, device="cpu", with_tokenizer=False)
        for lg, lr in zip(got.params["layers"], ref.params["layers"]):
            assert set(lg) == set(lr), case
            assert keys <= set(lg) and "ffn_up" not in lg, case
            assert lg["ffn_gate_up"].shape[0] == 2 * got.config.n_ff, case
        assert got.config.rope.interleaved and got.config.rope.dim == 8
        assert got.config.post_norms == (case != "chatglm") == ref.config.post_norms
        assert got.config.rope.freq_base == ref.config.rope.freq_base


def test_the_synthetic_configs_are_admitted():
    """GLM-4-9B-0414 and glm-4-9b-chat at their published widths: 16 query
    heads a kv head, rope over 64 of 128 dims; features outside the
    family stay refused by name on them."""
    for name in ("glm4-9b-0414", "glm-4-9b-chat"):
        cfg = synthetic.CONFIGS[name](n_layer=2)
        llama.check_supported(cfg)
        assert cfg.n_head // cfg.n_head_kv == 16 and cfg.rope.dim == 64
        kinds = synthetic.tensor_kinds(cfg, "Q4_K_M")["layers"][0]
        assert ("attn_qkv" in kinds) == (cfg.arch == "chatglm")
        # K 13696: ffn_down takes the 32-weight-block fallback
        assert kinds["ffn_down"] in ("Q5_0", "Q8_0")
    for field, value, words in (("post_norm_only", True, "post-norm-only"),
                                 ("n_head_kv_arr", (2, 2), "per-layer head counts"),
                                 ("residual_scale", 0.5, "residual scale")):
        cfg = synthetic.glm4_9b_0414_config(n_layer=2)
        with pytest.raises(NotImplementedError, match=words):
            llama.check_supported(ModelConfig(**{**cfg.__dict__, field: value}))


_SYNTH = {"glm4": dict(arch="glm4", qkv_bias=True, post_norms=True, fused_up=True,
                       n_head=4, n_head_kv=1, metadata={"glm4.rope.dimension_count": 32}),
          "chatglm": dict(arch="chatglm", fused_qkv=True, biases=("attn_qkv",), fused_up=True,
                          n_head=4, n_head_kv=1,
                          metadata={"chatglm.rope.dimension_count": 32})}


@pytest.mark.parametrize("case", sorted(_SYNTH))
def test_synthetic_params_are_a_loaded_file(tmp_path, case):
    """make_synthetic_params at each geometry is its Q4_K_M file loaded:
    glm4's biased q/k/v (Q4_K q/k and a Q6_K v apart, each with its bias),
    its post-norms and the fused ffn_up; chatglm's biased attn_qkv."""
    synthetic_matches_file(tmp_path, dict(_SYNTH[case], n_embd=256, n_ff=512))


def test_cli_runs_glm4(files, capsys):
    """tools/cli.py -m on a glm4 file: greedy text on the CPU."""
    from llamacog_tpu_torch.tools import cli

    assert cli.main(["-m", files["glm4"], "--device", "cpu", "--dtype", "f32", "--greedy",
                     "-n", "8", "-p", "hello"]) == 0
    assert "decode: 8" in capsys.readouterr().err


def test_q8_0_file_fuses_its_biased_qkv(files):
    """A glm4 file whose q, k and v are one kind fuses them, the biases
    concatenated in q, k, v order, as the JAX loader does."""
    got = load_model(files["glm4 Q8_0"], dtype=torch.float32, device="cpu",
                     with_tokenizer=False)
    ref = jax_load_model(files["glm4 Q8_0"], with_tokenizer=False, dtype=jnp.float32)
    for lg, lr in zip(got.params["layers"], ref.params["layers"]):
        np.testing.assert_array_equal(lg["attn_qkv_b"].numpy(), np.asarray(lr["attn_qkv_b"]))
