"""The GPT-NeoX, GPT-J and StableLM families in the port (gptneox, gptj,
stablelm), held against the JAX package.

Tiny random GGUFs (tests/test_torch_arch_qwen.py::write_gguf), 2 layers:
gptneox with use_parallel_residual (x + attn(attn_norm x) + ffn(ffn_norm x))
and without it (the sequential layer), one attn_qkv, biases on every
product and norm, rope on 8 of 32 dims (Pythia's 25%); gptj (rope on 32 of
each 128-dim head, interleaved pairs; q/k/v without biases, attn_v Q8_0
beside F32 q and k, so q+k fuse and attn_v stays apart; biased
FFN and LM head; one norm feeding both branches); stablelm (q/k/v biases,
a SiLU-gated FFN, rope on 8 of 32 dims). The prefill logits within 1e-4 of
max |logit| and 16 greedy tokens equal, f32 models, with the dense and the
q8_0 cache; the bf16 prefill logits within 3e-2 of max |logit|; a context
shift re-ropes the partial rope's dims alone, as the JAX engine's does.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llamacog_tpu.gguf import GGMLType
from llamacog_tpu.models.loader import load_model as jax_load_model
from llamacog_tpu_torch.models.loader import load_model

from .test_torch_arch_phi2 import bf16_prefill_close
from .test_torch_arch_qwen import (
    PROMPT, TOL, check_same_run, load_both, synthetic_matches_file, write_gguf)

NEOX = dict(arch="gptneox", n_embd=128, n_head=4, n_head_kv=4, n_ff=256, fused_qkv=True,
            ffn_gate=False, norm_bias=True, biases=("attn_qkv", "attn_output", "ffn_up",
                                                    "ffn_down"))
GPTJ = dict(arch="gptj", n_embd=256, n_head=2, n_head_kv=2, n_ff=256, ffn_norm=False,
            ffn_gate=False, norm_bias=True, biases=("ffn_up", "ffn_down", "output"),
            metadata={"gptj.rope.dimension_count": 32})
STABLELM = dict(arch="stablelm", n_embd=128, n_head=4, n_head_kv=4, n_ff=256, qkv_bias=True,
                norm_bias=True, metadata={"stablelm.rope.dimension_count": 8})
CASES = {
    "gptneox parallel": dict(NEOX, metadata={"gptneox.rope.dimension_count": 8}),
    "gptneox sequential": dict(NEOX, metadata={"gptneox.rope.dimension_count": 8,
                                               "gptneox.use_parallel_residual": False}),
    "gptj": dict(GPTJ, kind=lambda n: GGMLType.Q8_0 if "attn_v" in n else None),
    "stablelm": STABLELM,
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("arch_neox")
    return {name: write_gguf(str(root / f"{name.replace(' ', '_')}.gguf"), **case)
            for name, case in CASES.items()}


@pytest.mark.parametrize("kv_type", ["dense", "q8_0"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_tokens_match_jax(files, case, kv_type):
    check_same_run(files[case], kv_type)


def test_gptj_bf16_prefill_close_to_jax(files):
    bf16_prefill_close(files["gptj"])


def test_config_and_keys_follow_the_jax_loader(files):
    """Each file's config (the parallel residual from gptneox's key, the
    partial rope's dims, gptj's interleaved pairs, stablelm's SiLU gate)
    and the JAX loader's keys: gptneox's two norms, gptj's attn_qk + attn_v
    and output_b, stablelm's q/k/v biases."""
    want = {"gptneox parallel": (True, 8, False, "gelu"),
            "gptneox sequential": (False, 8, False, "gelu"),
            "gptj": (True, 32, True, "gelu"), "stablelm": (False, 8, False, "silu")}
    for case, (par, rdim, inter, act) in want.items():
        ref = jax_load_model(files[case], with_tokenizer=False, dtype=jnp.float32)
        got = load_model(files[case], dtype=torch.float32, device="cpu", with_tokenizer=False)
        cfg = got.config
        assert (cfg.parallel_residual, cfg.rope.dim, cfg.rope.interleaved, cfg.ffn_act) == \
            (par, rdim, inter, act), case
        assert (ref.config.parallel_residual, ref.config.rope.dim) == (par, rdim), case
        assert set(got.params) == set(ref.params), case
        for lg, lr in zip(got.params["layers"], ref.params["layers"]):
            assert set(lg) == set(lr), case
    neox = load_model(files["gptneox parallel"], device="cpu", with_tokenizer=False).params
    assert {"attn_norm", "ffn_norm", "ffn_norm_b", "attn_qkv_b"} <= set(neox["layers"][0])
    gptj = load_model(files["gptj"], device="cpu", with_tokenizer=False).params
    assert {"attn_qk", "attn_v", "ffn_up_b"} <= set(gptj["layers"][0]) and "output_b" in gptj


def test_shift_re_ropes_the_rotary_dims(files):
    """A shift of a partial-rope model (gptneox: 8 of 32 dims) rotates the
    moved keys' rotary dims and leaves the rest as they were, as the JAX
    shift's apply_rope(k, delta, cfg) does; the logits and greedy tokens
    after it equal the JAX engine's."""
    ref, eng, _ = load_both(files["gptneox parallel"], batch_size=1, max_seq=64)
    ref.prefill(PROMPT)
    eng.prefill(PROMPT)
    before = eng.cache.k[:, 0, 8:12].clone()
    ref.shift_row(0, 2, 6)
    eng.shift_row(0, 2, 6)
    moved = eng.cache.k[:, 0, 2:6]  # NeoX pairs (i, i + 4) of the first 8 dims rotate
    assert torch.equal(moved[..., 8:], before[..., 8:])
    assert not torch.allclose(moved[..., :8], before[..., :8], atol=1e-3)
    want = np.asarray(ref.decode_one(np.array([9])))
    got = eng.decode_one(np.array([9]))
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()
    first = np.array([int(np.argmax(want[0]))])
    np.testing.assert_array_equal(eng.decode_greedy_tokens(first, 8),
                                  np.asarray(ref.decode_greedy_tokens(first, 8)))


@pytest.mark.parametrize("case", ["gptneox parallel", "gptj", "stablelm"])
def test_synthetic_params_are_a_loaded_file(tmp_path, case):
    """make_synthetic_params at each family's geometry is the Q4_K_M file
    of that geometry loaded (the runs on the card stand for such files):
    the biases, the two norms of gptneox, no ffn_norm on gptj, stablelm's
    fused or apart q/k/v with their biases."""
    geo = {k: v for k, v in CASES[case].items() if k != "kind"}
    synthetic_matches_file(tmp_path, dict(geo, n_embd=256, n_ff=512))
