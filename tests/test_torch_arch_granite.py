"""The scaled families in the port (granite, granitemoe, minicpm), held
against the JAX package.

Tiny random GGUFs (tests/test_torch_arch_qwen.py::write_gguf) with the
three scales: the embedding's, the residual branches' and the logits'
(granite's logit_scale key a divisor: config.py turns it into its
inverse), and granite's attention scale from its key; minicpm's file
carries none of them and takes minicpm's defaults (embedding x 12, residual
x 1.4 / sqrt(n_layer), logits x 256 / n_embd). Granite's weights are Q8_0
(the wire products), granitemoe's experts too (the sparse wire path). The
f32 prefill logits within 1e-4 of max |logit| and 16 greedy tokens equal,
with the dense cache and, for granite, the q8_0 cache.
"""

import math

import pytest

import jax.numpy as jnp

from llamacog_tpu.gguf import GGMLType
from llamacog_tpu.models.loader import load_model as jax_load_model
from llamacog_tpu_torch.models.loader import load_model

from .test_torch_arch_qwen import check_same_run, synthetic_matches_file, write_gguf
from .test_torch_arch_qwen import one_torch_thread  # noqa: F401 (an autouse fixture)


def _scales(arch, logit):
    return {f"{arch}.embedding_scale": 12.0, f"{arch}.residual_scale": 0.22,
            f"{arch}.logit_scale": logit, f"{arch}.attention.scale": 0.125}


CASES = {
    "granite": dict(arch="granite", tied=True, kind=lambda n: GGMLType.Q8_0,
                    metadata=_scales("granite", 16.0)),
    "granitemoe": dict(arch="granitemoe", tied=True, n_expert=8, n_expert_used=2, n_ff_exp=64,
                       kind=lambda n: GGMLType.Q8_0 if "_exps" in n else None,
                       metadata=_scales("granitemoe", 6.0)),
    "minicpm": dict(arch="minicpm", tied=True),
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("arch_granite")
    return {name: write_gguf(str(root / f"{name}.gguf"), **case) for name, case in CASES.items()}


@pytest.mark.parametrize("case,kv_type", [("granite", "dense"), ("granite", "q8_0"),
                                          ("granitemoe", "dense"), ("minicpm", "dense")])
def test_scaled_tokens_match_jax(files, case, kv_type):
    check_same_run(files[case], kv_type)


def test_scales_follow_the_jax_config(files):
    """The config copy gives each scale as the JAX config does: granite's
    logit scale a divisor (1/16, 1/6), its attention scale from the key,
    minicpm's three defaults."""
    want = {"granite": (12.0, 0.22, 1 / 16.0, 0.125),
            "granitemoe": (12.0, 0.22, 1 / 6.0, 0.125),
            "minicpm": (12.0, 1.4 / math.sqrt(2), 256.0 / 64, 0.25)}
    for case, scales in want.items():
        ref = jax_load_model(files[case], with_tokenizer=False, dtype=jnp.float32).config
        got = load_model(files[case], device="cpu", with_tokenizer=False).config
        for f, value in zip(("embd_scale", "residual_scale", "logit_scale", "kq_scale"), scales):
            assert getattr(got, f) == getattr(ref, f) == pytest.approx(value), (case, f)


@pytest.mark.parametrize("case", sorted(CASES))
def test_synthetic_params_are_a_loaded_file(tmp_path, case):
    """make_synthetic_params at each file's geometry is its Q4_K_M file
    loaded (the tied heads, granitemoe's experts)."""
    geo = {k: v for k, v in CASES[case].items() if k != "kind"}
    synthetic_matches_file(tmp_path, dict(geo, n_embd=256, n_ff=256, n_ff_exp=256))
