"""The squared-ReLU FFN in the port (nemotron, arcee), held against the JAX
package.

Tiny random GGUFs, 2 layers: arcee by the JAX package's own oracle spec
(tests/test_e2e_oracle.py::ARCH_ORACLE_SPECS["arcee"], written by
make_tiny_arch_gguf: the llama graph with an ungated relu^2 FFN,
interleaved rope); nemotron by tests/test_torch_arch_qwen.py::write_gguf
(Minitron's layout in small: layer norms with their biases, q/k/v apart,
GQA 4 over 2, an ungated relu^2 FFN and rope on 16 of each head's 32
dims). The f32 prefill logits within 1e-4 of max |logit| and 16 greedy
tokens equal, with the dense and the q8_0 cache.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llamacog_tpu.gguf import GGMLType
from llamacog_tpu.models import llama as jax_llama
from llamacog_tpu.models.loader import load_model as jax_load_model
from llamacog_tpu.utils.testing import make_tiny_arch_gguf
from llamacog_tpu_torch.models import llama
from llamacog_tpu_torch.models.loader import load_model
from llamacog_tpu_torch.utils import synthetic

from .test_torch_arch_qwen import check_same_run, synthetic_matches_file, write_gguf
from .test_torch_arch_qwen import one_torch_thread  # noqa: F401 (an autouse fixture)

NEMOTRON = dict(arch="nemotron", n_embd=128, n_head=4, n_head_kv=2, n_ff=256, ffn_gate=False,
                norm_bias=True, metadata={"nemotron.rope.dimension_count": 16})
# Q8_0 products: the relu^2 FFN over wire weights
CASES = {"nemotron": NEMOTRON,
         "nemotron Q8_0": dict(NEMOTRON, kind=lambda n: GGMLType.Q8_0 if "blk." in n else None)}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("arch_relu2")
    out = {name: write_gguf(str(root / f"{name.replace(' ', '_')}.gguf"), **case)
           for name, case in CASES.items()}
    # tests/test_e2e_oracle.py::ARCH_ORACLE_SPECS["arcee"]
    out["arcee"] = make_tiny_arch_gguf(str(root / "arcee.gguf"), "arcee", seed=17, gate=False)
    return out


@pytest.mark.parametrize("case,kv_type", [("nemotron", "dense"), ("nemotron", "q8_0"),
                                          ("nemotron Q8_0", "dense"), ("arcee", "dense"),
                                          ("arcee", "q8_0")])
def test_relu2_tokens_match_jax(files, case, kv_type):
    check_same_run(files[case], kv_type)


def test_relu2_activation_matches_jax():
    """relu(x)^2 in f32, bit for bit, from bf16 and f32 inputs."""
    x = np.random.default_rng(0).standard_normal((4, 64)).astype(np.float32) * 3
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = llama._act(torch.from_numpy(x).to(dt), "relu2").numpy()
        want = np.asarray(jax_llama._act(jnp.asarray(x).astype(jdt), "relu2"))
        np.testing.assert_array_equal(got, want)
        assert (got >= 0).all() and (got[x < 0] == 0).all()


def test_relu2_ffn_matches_jax(files):
    """The ungated relu^2 FFN of the first nemotron layer against the JAX
    _ffn on the same input: act(up + bias) -> down, within 1e-5."""
    ref = jax_load_model(files["nemotron Q8_0"], with_tokenizer=False, dtype=jnp.float32)
    got = load_model(files["nemotron Q8_0"], dtype=torch.float32, device="cpu",
                     with_tokenizer=False)
    layer = got.params["layers"][0]
    assert "ffn_gate" not in layer and "ffn_gate_up" not in layer
    x = np.random.default_rng(1).standard_normal((1, 5, 128)).astype(np.float32)
    want = np.asarray(jax_llama._ffn(ref.params["layers"][0], jnp.asarray(x), ref.config))
    out = llama._ffn(layer, torch.from_numpy(x), got.config).numpy()
    assert np.abs(out - want).max() <= 1e-5 * np.abs(want).max()


def test_keys_and_config_follow_the_jax_loader(files):
    """nemotron: layer norms with their biases, partial rope (16 of 32 dims,
    NeoX pairs); arcee: rms norms, interleaved rope; both relu^2, no gate."""
    for case in ("nemotron", "nemotron Q8_0", "arcee"):
        ref = jax_load_model(files[case], with_tokenizer=False, dtype=jnp.float32)
        got = load_model(files[case], dtype=torch.float32, device="cpu", with_tokenizer=False)
        assert set(got.params) == set(ref.params), case
        assert set(got.params["layers"][0]) == set(ref.params["layers"][0]), case
        assert got.config.ffn_act == ref.config.ffn_act == "relu2"
        assert dataclasses.astuple(got.config.rope) == dataclasses.astuple(ref.config.rope)
        assert got.config.norm_type == ref.config.norm_type
    nem = load_model(files["nemotron"], device="cpu", with_tokenizer=False)
    assert nem.config.norm_type == "layer" and nem.config.rope.dim == 16
    assert not nem.config.rope.interleaved and {"attn_norm_b", "ffn_norm_b"} <= set(
        nem.params["layers"][0])
    assert load_model(files["arcee"], device="cpu", with_tokenizer=False).config.rope.interleaved


@pytest.mark.parametrize("case", ["nemotron", "arcee"])
def test_synthetic_params_are_a_loaded_file(tmp_path, case):
    """make_synthetic_params at each geometry is its Q4_K_M file loaded:
    no ffn_gate; nemotron's norm biases."""
    geo = NEMOTRON if case == "nemotron" else dict(arch="arcee", ffn_gate=False)
    synthetic_matches_file(tmp_path, dict(geo, n_embd=256, n_ff=512))


def test_the_synthetic_configs_are_admitted():
    """Minitron-4B and AFM-4.5B are admitted at their published widths; an
    arch outside the ported families (mamba) stays refused by name."""
    for name in ("minitron-4b", "afm-4.5b"):
        cfg = synthetic.CONFIGS[name](n_layer=2)
        llama.check_supported(cfg)
        assert cfg.ffn_act == "relu2" and "ffn_gate" not in synthetic.tensor_kinds(cfg)[
            "layers"][0]
    cfg = synthetic.minitron_4b_config(n_layer=2)
    with pytest.raises(NotImplementedError, match="architecture 'mamba' is not ported"):
        llama.check_supported(type(cfg)(**{**cfg.__dict__, "arch": "mamba"}))
