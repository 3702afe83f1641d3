"""MLA with minicpm's scales (minicpm3) and without (plm) in the port, held
against the JAX package.

Tiny random F32 GGUFs, 2 layers, by the JAX package's own specs
(tests/test_model_e2e.py's minicpm3 and plm files, written by
make_tiny_arch_gguf: minicpm3's q LoRA and compressed kv, plm's direct
attn_q and ungated squared-ReLU FFN, tied head), and by
tests/test_torch_arch_qwen.py::write_gguf a minicpm3 file with longrope
factors (a context past the original one reads the long table) and one
whose residual scale, 0.25, would move every logit if the MLA layers
applied it: the JAX forward's MLA branch applies none (llama.cpp's
llm_build_minicpm3 scales both branches), and the port keeps that parity.
The f32 prefill logits within 1e-4 of max |logit| and 16 greedy tokens
equal, with the dense and the q8_0 cache.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llamacog_tpu.models.loader import load_model as jax_load_model
from llamacog_tpu.utils.testing import make_tiny_arch_gguf
from llamacog_tpu_torch.models import llama
from llamacog_tpu_torch.models.config import ModelConfig
from llamacog_tpu_torch.models.loader import load_model
from llamacog_tpu_torch.runtime.engine import Engine
from llamacog_tpu_torch.utils import synthetic

from .test_torch_arch_qwen import PROMPT, check_same_run, synthetic_matches_file, write_gguf
from .test_torch_arch_qwen import one_torch_thread  # noqa: F401 (an autouse fixture)

# tests/test_model_e2e.py's two MLA files: (q_lora, kv_lora, rope, nope, v)
E2E = {
    "minicpm3": dict(seed=6, n_head_kv=4, mla=(32, 32, 16, 16, 16), extra_metadata={
        "minicpm3.attention.q_lora_rank": 32, "minicpm3.attention.kv_lora_rank": 32,
        "minicpm3.attention.key_length": 32, "minicpm3.attention.value_length": 16,
        "minicpm3.rope.dimension_count": 16}),
    "plm": dict(seed=8, n_head_kv=4, gate=False, output=False, mla=(0, 32, 16, 16, 16),
                extra_metadata={"plm.attention.kv_lora_rank": 32,
                                "plm.attention.key_length": 32,
                                "plm.attention.value_length": 16,
                                "plm.rope.dimension_count": 16}),
}
MLA = {"kv_lora": 32, "q_lora": 32, "rope": 16, "nope": 16, "v": 16}
LONGROPE = dict(arch="minicpm3", n_head=4, n_head_kv=4, mla=MLA,
                rope_factors=(np.linspace(1.0, 4.0, 8), np.linspace(1.0, 1.5, 8)),
                metadata={"minicpm3.rope.scaling.original_context_length": 128})
SCALED = dict(arch="minicpm3", n_head=4, n_head_kv=4, mla=MLA, seed=3,
              metadata={"minicpm3.residual_scale": 0.25})


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("arch_mla_scaled")
    out = {}
    for arch, spec in E2E.items():
        spec = dict(spec)
        out[arch] = make_tiny_arch_gguf(str(root / f"{arch}.gguf"), arch, seed=spec.pop("seed"),
                                        **spec)
    out["minicpm3 longrope"] = write_gguf(str(root / "longrope.gguf"), **LONGROPE)
    out["minicpm3 scaled"] = write_gguf(str(root / "scaled.gguf"), **SCALED)
    return out


@pytest.mark.parametrize("case,kv_type", [
    ("minicpm3", "dense"), ("minicpm3", "q8_0"), ("plm", "dense"), ("plm", "q8_0"),
    ("minicpm3 scaled", "dense"), ("minicpm3 scaled", "q8_0")])
def test_greedy_tokens_match_jax(files, case, kv_type):
    check_same_run(files[case], kv_type)


@pytest.mark.parametrize("max_seq", [64, 256])
def test_longrope_tables_match_jax(files, max_seq):
    """minicpm3's rope factors by context: the short table within the
    original 128 positions, the long one past them (rope_factors, as phi3)."""
    check_same_run(files["minicpm3 longrope"], max_seq=max_seq)


def test_mla_layers_take_no_residual_scale(files):
    """The file's residual scale is 0.25 (its GGUF key), which the port's
    config keeps, as the JAX config does, and the MLA layers ignore it: the
    logits are those of the same model at scale 1, bit for bit (the greedy
    case above holds them against the JAX package). The embedding and logit
    scales (minicpm's 12 and 256 / n_embd) do apply."""
    m = load_model(files["minicpm3 scaled"], dtype=torch.float32, device="cpu",
                   with_tokenizer=False)
    ref = jax_load_model(files["minicpm3 scaled"], with_tokenizer=False, dtype=jnp.float32)
    assert m.config.residual_scale == ref.config.residual_scale == 0.25
    assert m.config.embd_scale == 12.0 and m.config.logit_scale == 256.0 / 64
    outs = []
    for cfg in (m.config, dataclasses.replace(m.config, residual_scale=1.0)):
        eng = Engine(m.params, cfg, max_seq=64, dtype=torch.float32, device="cpu")
        outs.append(eng.prefill(PROMPT))
    np.testing.assert_array_equal(outs[0], outs[1])


def test_keys_and_config_follow_the_jax_loader(files):
    """The port's config and layer keys are the JAX loader's: minicpm3's q
    LoRA (attn_q_a, its norm, attn_q_b_proj), plm's direct attn_q and its
    lone ffn_up; the longrope file's two tables."""
    for case in files:
        ref = jax_load_model(files[case], with_tokenizer=False, dtype=jnp.float32)
        got = load_model(files[case], dtype=torch.float32, device="cpu", with_tokenizer=False)
        assert set(got.params) == set(ref.params), case
        for lg, lr in zip(got.params["layers"], ref.params["layers"]):
            assert set(lg) == set(lr), case
        for f in ("n_lora_q", "n_lora_kv", "residual_scale", "logit_scale", "embd_scale",
                  "ffn_act", "n_head_kv"):
            assert getattr(got.config, f) == getattr(ref.config, f), (case, f)
    layer = load_model(files["plm"], device="cpu", with_tokenizer=False).params["layers"][0]
    assert {"attn_q", "attn_kv_a_mqa", "ffn_up"} <= set(layer) and "ffn_gate" not in layer
    assert {"rope_long", "rope_short"} <= set(load_model(
        files["minicpm3 longrope"], device="cpu", with_tokenizer=False).params)


def test_the_synthetic_configs_are_admitted_and_mla_refusals_stay():
    """check_supported admits MiniCPM3-4B and PLM-1.8B at their published
    widths; it refuses by name a minicpm3 or plm config whose kv heads are
    fewer than its query heads (the JAX MLA branch writes K of n_head heads
    into a cache of head_count_kv heads), and MLA on an arch outside the MLA
    families (glm4, chameleon)."""
    for name in ("minicpm3-4b", "plm-1.8b"):
        llama.check_supported(synthetic.CONFIGS[name](n_layer=2))
    for name in ("minicpm3-4b", "plm-1.8b"):
        cfg = synthetic.CONFIGS[name](n_layer=2)
        with pytest.raises(NotImplementedError, match="head_count_kv != head_count"):
            llama.check_supported(ModelConfig(**{**cfg.__dict__, "n_head_kv": 8}))
    for name in ("glm4-9b-0414", "chameleon-7b"):
        cfg = synthetic.CONFIGS[name](n_layer=2)
        with pytest.raises(NotImplementedError, match="MLA"):
            llama.check_supported(ModelConfig(**{**cfg.__dict__, "n_lora_kv": 64}))


# write_gguf geometries of the two configs (n_embd 256, n_ff 512); K 64 of
# the LoRA products takes the 32-block fallback
_SYNTH = {"minicpm3": dict(arch="minicpm3", n_head=4, n_head_kv=4,
                           mla={"kv_lora": 64, "q_lora": 64, "rope": 16, "nope": 48, "v": 64},
                           rope_factors=(np.linspace(1.0, 4.0, 8), np.ones(8)),
                           metadata={"minicpm3.rope.scaling.original_context_length": 256}),
          "plm": dict(arch="plm", n_head=4, n_head_kv=4, tied=True, ffn_gate=False,
                      mla={"kv_lora": 64, "q_lora": 0, "rope": 16, "nope": 48, "v": 64})}


@pytest.mark.parametrize("case", sorted(_SYNTH))
def test_synthetic_params_are_a_loaded_file(tmp_path, case):
    """make_synthetic_params at each geometry is its Q4_K_M file loaded:
    minicpm3's q LoRA and longrope tables, plm's direct attn_q, ungated FFN
    and tied head."""
    synthetic_matches_file(tmp_path, dict(_SYNTH[case], n_embd=256, n_ff=512))


def test_cli_runs_minicpm3(files, capsys):
    """tools/cli.py -m on a minicpm3 file: greedy text on the CPU."""
    from llamacog_tpu_torch.tools import cli

    assert cli.main(["-m", files["minicpm3"], "--device", "cpu", "--dtype", "f32", "--greedy",
                     "-n", "8", "-p", "hello"]) == 0
    assert "decode: 8" in capsys.readouterr().err
