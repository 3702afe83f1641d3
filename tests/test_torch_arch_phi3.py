"""The phi3 family in the port (Phi-3/3.5, Phi-4), held against the JAX
package.

Tiny random GGUFs (tests/test_torch_arch_qwen.py::write_gguf): one attn_qkv
tensor and a pre-fused ffn_up of 2 x n_ff rows, which both loaders turn
into ffn_gate_up. Phi-3.5 style: head dim 96, longrope's long and short
factor tables over an original context of 64 positions (and the
rope.scaling.attn_factor llama.cpp's converter writes), all Q8_0; the
engine runs at max_seq 64 (the short factors) and 256 (the long ones), so
each table is taken once, with the dense and the q8_0 cache. Phi-4 style:
GQA (4 query heads over 1 kv head), no factors, F32. The prefill logits
within 1e-4 of max |logit| and 16 greedy tokens equal, f32 models.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llamacog_tpu.gguf import GGMLType
from llamacog_tpu.models import llama as jax_llama
from llamacog_tpu.models.loader import load_model as jax_load_model
from llamacog_tpu_torch.models import llama
from llamacog_tpu_torch.models.loader import load_model

from .test_torch_arch_qwen import PROMPT, TOL, check_same_run, load_both, write_gguf

ORIG_CTX = 64
HALF = 48  # head dim 96: 48 rotary pairs, as Phi-3.5-mini's 48 factors
LONG = np.linspace(1.0, 12.0, HALF)
SHORT = 1.0 + np.linspace(0.0, 0.2, HALF)
CASES = {
    "phi3.5": dict(arch="phi3", n_embd=192, n_head=2, n_head_kv=2, head_dim=96, n_ff=128,
                   fused_qkv=True, fused_up=True, rope_factors=(LONG, SHORT),
                   kind=lambda n: GGMLType.Q8_0,
                   metadata={"phi3.rope.scaling.original_context_length": ORIG_CTX,
                             "phi3.rope.scaling.attn_factor":
                                 math.sqrt(1 + math.log(4) / math.log(ORIG_CTX))}),
    "phi4": dict(arch="phi3", n_embd=128, n_head=4, n_head_kv=1, head_dim=32, n_ff=96,
                 fused_qkv=True, fused_up=True),
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("arch_phi3")
    return {name: write_gguf(str(root / f"{name}.gguf"), **case)
            for name, case in CASES.items()}


@pytest.mark.parametrize("kv_type", ["dense", "q8_0"])
@pytest.mark.parametrize("max_seq", [ORIG_CTX, 256])
def test_longrope_tokens_match_jax(files, max_seq, kv_type):
    check_same_run(files["phi3.5"], kv_type, max_seq=max_seq)


@pytest.mark.parametrize("kv_type", ["dense", "q8_0"])
def test_phi4_tokens_match_jax(files, kv_type):
    check_same_run(files["phi4"], kv_type)


def test_factor_tables_follow_the_context(files):
    """rope_factors picks the short table up to the original context and the
    long one past it, as the JAX _rope_factors; the fused tensors keep the
    JAX loader's keys (attn_qkv, ffn_gate_up of 2 x n_ff rows)."""
    ref = jax_load_model(files["phi3.5"], with_tokenizer=False, dtype=jnp.float32)
    got = load_model(files["phi3.5"], dtype=torch.float32, device="cpu", with_tokenizer=False)
    for max_seq, table in ((ORIG_CTX, SHORT), (ORIG_CTX + 1, LONG), (256, LONG)):
        ff = llama.rope_factors(got.params, got.config, max_seq)
        np.testing.assert_array_equal(ff.numpy(), table.astype(np.float32))
        np.testing.assert_array_equal(
            np.asarray(jax_llama._rope_factors(ref.params, ref.config, max_seq)), ff.numpy())
    layer = got.params["layers"][0]
    assert set(layer) == set(ref.params["layers"][0])
    assert {"attn_qkv", "ffn_gate_up"} <= set(layer) and "ffn_up" not in layer
    assert layer["ffn_gate_up"].shape == (2 * 128, 192)


def test_attn_factor_is_read_under_yarn_only(files):
    """llama.cpp's converter writes Phi-3's rope.scaling.attn_factor
    (sqrt(1 + ln(scale) / ln(orig_ctx))); the JAX rope applies attn_factor
    under YaRN only, so a phi3 file's changes nothing, and the port keeps
    that parity: the same tables as with the factor 1."""
    from llamacog_tpu_torch.models.config import RopeConfig
    from llamacog_tpu_torch.ops.rope import rope_tables

    cfg = load_model(files["phi3.5"], device="cpu", with_tokenizer=False).config
    assert cfg.rope.attn_factor > 1.1 and cfg.rope.scaling_type == "none"
    pos = torch.arange(8)[None]
    got = rope_tables(pos, cfg.rope, 96)
    want = rope_tables(pos, RopeConfig(dim=96, freq_base=cfg.rope.freq_base), 96)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_context_shift_takes_the_long_factors(files):
    """A shift at max_seq 256 (past the original context) re-ropes the moved
    keys with the long table, as the JAX engine's shift does: the logits and
    the greedy tokens after it equal the JAX engine's."""
    ref, eng, _ = load_both(files["phi3.5"], batch_size=1, max_seq=256)
    ref.prefill(PROMPT)
    eng.prefill(PROMPT)
    ref.shift_row(0, 2, 6)
    eng.shift_row(0, 2, 6)
    want = np.asarray(ref.decode_one(np.array([9])))
    got = eng.decode_one(np.array([9]))
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()
    first = np.array([int(np.argmax(want[0]))])
    np.testing.assert_array_equal(eng.decode_greedy_tokens(first, 8),
                                  np.asarray(ref.decode_greedy_tokens(first, 8)))


def test_cli_runs_phi3_5_mini_by_name(capsys, monkeypatch):
    """tools/cli.py -m synthetic:phi3.5-mini (cut to 1 layer here) on the
    CPU: its synthetic vocab has the model's 32064 ids (the plain tokens end
    early, the ten special ones last), so every id the tokenizer gives is
    in the embedding."""
    from llamacog_tpu_torch.tools import cli
    from llamacog_tpu_torch.utils import synthetic

    monkeypatch.setitem(synthetic.CONFIGS, "phi3.5-mini",
                        lambda: synthetic.phi3_5_mini_config(n_layer=1))
    vocab = synthetic.synthetic_vocab(32064)
    assert len(vocab.tokens) == 32064 and vocab.eos_id == 32055
    assert cli.main(["-m", "synthetic:phi3.5-mini", "--device", "cpu", "-n", "2", "--greedy",
                     "-p", "<t300><t31000>"]) == 0
    assert "[perf] prompt:" in capsys.readouterr().err
