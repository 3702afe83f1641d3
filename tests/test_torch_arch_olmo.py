"""The OLMo families in the port (olmo, olmo2, olmoe), held against the JAX
package.

Tiny random GGUFs: olmo by the JAX package's own oracle spec
(tests/test_e2e_oracle.py::ARCH_ORACLE_SPECS["olmo"], make_tiny_arch_gguf:
no norm tensor at all, so every layer norm is the non-parametric one),
with clamp_kqv set low enough to clip; olmo2 (no pre-norms, the attention
and FFN outputs normed, q/k norms over the whole projection) and olmoe
(MoE, 8 experts top 2, with the whole-projection q/k norms) by
tests/test_torch_arch_qwen.py::write_gguf. The f32 prefill logits within
1e-4 of max |logit| and 16 greedy tokens equal, with the dense cache and,
for olmo2, the q8_0 cache.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llamacog_tpu.gguf import GGMLType
from llamacog_tpu.models.loader import load_model as jax_load_model
from llamacog_tpu.utils.testing import make_tiny_arch_gguf
from llamacog_tpu_torch.models.loader import load_model
from llamacog_tpu_torch.runtime.engine import Engine

from .test_torch_arch_qwen import PROMPT, check_same_run, synthetic_matches_file, write_gguf
from .test_torch_arch_qwen import one_torch_thread  # noqa: F401 (an autouse fixture)

CLAMP = 0.25  # below the tiny model's largest q/k/v activations: the clamp binds
CASES = {
    "olmo2": dict(arch="olmo2", attn_norm=False, ffn_norm=False, post_norms=True,
                  qk_norm="full"),
    "olmoe": dict(arch="olmoe", qk_norm="full", n_expert=8, n_expert_used=2, n_ff_exp=64,
                  kind=lambda n: GGMLType.Q8_0 if "_exps" in n else None,
                  metadata={"olmoe.expert_weights_norm": False}),
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("arch_olmo")
    out = {name: write_gguf(str(root / f"{name}.gguf"), **case) for name, case in CASES.items()}
    out["olmo"] = make_tiny_arch_gguf(str(root / "olmo.gguf"), "olmo", seed=17, norms=False,
                                      norm="layer",
                                      extra_metadata={"olmo.attention.clamp_kqv": CLAMP})
    return out


@pytest.mark.parametrize("case,kv_type", [("olmo", "dense"), ("olmo2", "dense"),
                                          ("olmo2", "q8_0"), ("olmoe", "dense")])
def test_olmo_tokens_match_jax(files, case, kv_type):
    check_same_run(files[case], kv_type)


def test_config_and_keys_follow_the_jax_loader(files):
    """olmo: layer norm with no tensor (no attn_norm, ffn_norm or
    output_norm in either tree) and the file's clamp; olmo2 and olmoe: q, k
    and v apart under the whole-projection q/k norms (the JAX loader fuses
    neither q/k/v nor q+k there), the norms as wide as q and k; olmo2 keeps
    only its post norms."""
    for case in ("olmo", "olmo2", "olmoe"):
        ref = jax_load_model(files[case], with_tokenizer=False, dtype=jnp.float32)
        got = load_model(files[case], dtype=torch.float32, device="cpu", with_tokenizer=False)
        assert set(got.params) == set(ref.params), case
        assert set(got.params["layers"][0]) == set(ref.params["layers"][0]), case
        for f in ("nonparam_norms", "post_norm_only", "qk_norm_full", "attn_clamp",
                  "expert_weights_norm", "norm_type"):
            assert getattr(got.config, f) == getattr(ref.config, f), (case, f)
    olmo = load_model(files["olmo"], device="cpu", with_tokenizer=False)
    assert olmo.config.nonparam_norms and olmo.config.attn_clamp == CLAMP
    assert "output_norm" not in olmo.params
    assert not {"attn_norm", "ffn_norm"} & set(olmo.params["layers"][0])
    for case in ("olmo2", "olmoe"):
        layer = load_model(files[case], device="cpu", with_tokenizer=False).params["layers"][0]
        assert {"attn_q", "attn_k", "attn_v"} <= set(layer), case
        assert layer["attn_q_norm"].shape == (64,) and layer["attn_k_norm"].shape == (32,)
    layer = load_model(files["olmo2"], device="cpu", with_tokenizer=False).params["layers"][0]
    assert {"attn_post_norm", "ffn_post_norm"} <= set(layer)
    assert not {"attn_norm", "ffn_norm"} & set(layer)


def test_the_clamp_binds(files):
    """The olmo file's clamp changes the logits (so the token test holds the
    clamp), against the same model without it."""
    m = load_model(files["olmo"], dtype=torch.float32, device="cpu", with_tokenizer=False)
    clamped = Engine(m.params, m.config, max_seq=64, dtype=torch.float32,
                     device="cpu").prefill(PROMPT)
    m.config.attn_clamp = 0.0
    free = Engine(m.params, m.config, max_seq=64, dtype=torch.float32,
                  device="cpu").prefill(PROMPT)
    assert np.abs(clamped - free).max() > 1e-3 * np.abs(free).max()


@pytest.mark.parametrize("case", ["olmo", "olmo2", "olmoe"])
def test_synthetic_params_are_a_loaded_file(tmp_path, case):
    """make_synthetic_params at each file's geometry is its Q4_K_M file
    loaded: olmo's with no norm tensor, q, k and v apart with the
    whole-projection norms, olmo2's post norms alone."""
    geo = {k: v for k, v in CASES.get(case, dict(arch="olmo", norms=False)).items()
           if k != "kind"}
    synthetic_matches_file(tmp_path, dict(geo, n_embd=256, n_ff=256, n_ff_exp=256))
