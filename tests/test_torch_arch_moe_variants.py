"""The MoE variants of the generalized transformer in the port (deepseek,
dots1, bailingmoe, phimoe, grok, arctic, dbrx), held against the JAX
package, on F32 files: the experts take the all-expert einsums.

Tiny random GGUFs, 2 layers: deepseek, dots1, bailingmoe, grok and arctic
by the JAX package's own oracle specs (tests/test_e2e_oracle.py::
ARCH_ORACLE_SPECS, written by make_tiny_arch_gguf: deepseek's dense lead
layer, shared expert and routed scale 1.5; dots1's per-head q/k norms,
sigmoid router with its selection bias, renormalized; bailingmoe's shared
expert; grok's embedding and logit scales, softcap 30 at its fixed scale,
BERT-named post-norms and GELU experts; arctic's dense FFN with the MoE
branch on the layer input), phimoe by make_tiny_phimoe_gguf (rms norms
with biases, q/k/v, output and LM head biases) and dbrx by
tests/test_torch_arch_qwen.py::write_gguf (layer norms without a bias, one
attn_qkv, its pre-FFN norm under the name attn_output_norm, and a
clamp_kqv low enough to clip the tiny model's q/k/v). The f32 prefill
logits within 1e-4 of max |logit| and 16 greedy tokens equal, with the
dense cache and, for dbrx and dots1, the q8_0 cache. The files whose
expert stacks are quantized, which take the sparse routes, are in
tests/test_torch_arch_moe_variants_quant.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llamacog_tpu.models import llama as jax_llama
from llamacog_tpu.models.loader import load_model as jax_load_model
from llamacog_tpu.utils.testing import make_tiny_arch_gguf, make_tiny_phimoe_gguf
from llamacog_tpu_torch.models import llama
from llamacog_tpu_torch.models.config import ModelConfig, RopeConfig
from llamacog_tpu_torch.models.loader import load_model
from llamacog_tpu_torch.utils import synthetic

from .test_e2e_oracle import ARCH_ORACLE_SPECS
from .test_torch_arch_qwen import check_same_run, synthetic_matches_file, write_gguf
from .test_torch_arch_qwen import one_torch_thread  # noqa: F401 (an autouse fixture)

# the JAX package's oracle specs of five of the variants, each with the
# seed its oracle test writes it with
SPECS = {arch: {"seed": 17, **ARCH_ORACLE_SPECS[arch]}
         for arch in ("deepseek", "grok", "arctic", "dots1", "bailingmoe")}
CLAMP = 0.25  # below the tiny DBRX's largest q/k/v activations: the clamp binds
DBRX = dict(arch="dbrx", n_embd=128, n_head=4, n_head_kv=2, n_ff=96, fused_qkv=True,
            ffn_norm="attn_output_norm", n_expert=8, n_expert_used=4,
            metadata={"dbrx.attention.clamp_kqv": CLAMP})


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("arch_moe_variants")
    out = {}
    for arch, spec in SPECS.items():
        spec = dict(spec)
        out[arch] = make_tiny_arch_gguf(str(root / f"{arch}.gguf"), arch,
                                        seed=spec.pop("seed"), **spec)
    out["phimoe"] = make_tiny_phimoe_gguf(str(root / "phimoe.gguf"), seed=3)
    out["dbrx"] = write_gguf(str(root / "dbrx.gguf"), **DBRX)
    return out


@pytest.mark.parametrize("case,kv_type", [
    ("deepseek", "dense"), ("dots1", "dense"), ("dots1", "q8_0"), ("bailingmoe", "dense"),
    ("phimoe", "dense"), ("grok", "dense"), ("arctic", "dense"), ("dbrx", "dense"),
    ("dbrx", "q8_0")])
def test_greedy_tokens_match_jax(files, case, kv_type):
    check_same_run(files[case], kv_type)


# each file's own tensors in the port's keys: the renames (dbrx's and
# grok's BERT-named norms), arctic's dense FFN beside its experts and its
# branch norm, the selection bias, phimoe's biases
KEYS = {"deepseek": {"ffn_gate_inp", "ffn_up_shexp", "ffn_gate_exps"},
        "dots1": {"exp_probs_b", "attn_q_norm", "attn_k_norm", "ffn_up_shexp"},
        "bailingmoe": {"ffn_gate_inp", "ffn_up_shexp"},
        "phimoe": {"attn_norm_b", "ffn_norm_b", "attn_qkv_b", "attn_output_b"},
        "grok": {"attn_post_norm", "ffn_post_norm"},
        "arctic": {"ffn_gate_up", "ffn_down", "ffn_norm_exps", "ffn_gate_inp"},
        "dbrx": {"attn_qkv", "ffn_norm"}}


def _fields(cfg) -> dict:
    """A config's fields, its rope's as a dict, the metadata left out."""
    out = {k: v for k, v in cfg.__dict__.items() if k not in ("metadata", "rope")}
    return {**out, "rope": dict(cfg.rope.__dict__)}


@pytest.mark.parametrize("case", sorted(KEYS))
def test_keys_and_config_follow_the_jax_loader(files, case):
    """The port's config and every layer's parameter keys are the JAX
    loader's: grok's attn_output_norm and layer_output_norm become its
    post-norms and dbrx's attn_output_norm its ffn_norm, none of the
    BERT-named keys left; arctic keeps ffn_norm_exps in the model dtype, as
    the JAX loader does (its name does not end in _norm.weight), and every
    norm and bias stays f32."""
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        ref = jax_load_model(files[case], with_tokenizer=False, dtype=jdtype)
        got = load_model(files[case], dtype=dtype, device="cpu", with_tokenizer=False)
        assert _fields(got.config) == _fields(ref.config), case
        assert set(got.params) == set(ref.params), case
        for il, (lg, lr) in enumerate(zip(got.params["layers"], ref.params["layers"])):
            assert set(lg) == set(lr), (case, il)
            assert not {"attn_out_norm", "layer_out_norm"} & set(lg), (case, il)
            for key, w in lg.items():
                if isinstance(w, torch.Tensor):
                    assert str(w.dtype).split(".")[-1] == str(lr[key].dtype), (case, key)
        assert KEYS[case] <= set(got.params["layers"][-1]), case
        if case == "arctic":
            assert got.params["layers"][0]["ffn_norm_exps"].dtype == dtype


def test_router_with_a_selection_bias_matches_jax():
    """dots1's router: sigmoid scores, the top 6 of score + bias, weights
    taken from the scores before the bias, renormalized and scaled by 2.5;
    the selected sets and their weights are the JAX router's (compared as
    sets: a tie may order the indices otherwise), over seeded logits with
    ties built in."""
    cfg = synthetic.dots1_config(n_layer=2)
    n_exp = 16
    cfg = ModelConfig(**{**cfg.__dict__, "n_expert": n_exp, "n_embd": n_exp})
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((8, n_exp)).astype(np.float32)
    logits[:, 3] = logits[:, 4]  # ties in the scores
    bias = (rng.standard_normal(n_exp) * 0.5).astype(np.float32)
    bias[7] = bias[8]
    layer = {"ffn_gate_inp": torch.eye(n_exp), "exp_probs_b": torch.from_numpy(bias)}
    top_i, gate_w = llama._moe_router(layer, torch.from_numpy(logits), cfg)
    ref_i, ref_w = jax_llama._moe_router({"ffn_gate_inp": jnp.eye(n_exp),
                                          "exp_probs_b": jnp.asarray(bias)},
                                         jnp.asarray(logits), cfg)
    ref_i, ref_w = np.asarray(ref_i), np.asarray(ref_w)
    for r in range(logits.shape[0]):
        got = dict(zip(top_i[r].tolist(), gate_w[r].tolist()))
        want = dict(zip(ref_i[r].tolist(), ref_w[r].tolist()))
        assert set(got) == set(want), r
        np.testing.assert_allclose([got[e] for e in sorted(got)],
                                   [want[e] for e in sorted(want)], rtol=1e-6)
        assert sum(got.values()) == pytest.approx(2.5, rel=1e-5)


def test_cli_runs_grok(files, capsys):
    """tools/cli.py -m on a grok file: greedy text on the CPU."""
    from llamacog_tpu_torch.tools import cli

    assert cli.main(["-m", files["grok"], "--device", "cpu", "--dtype", "f32", "--greedy",
                     "-n", "8", "-p", "hello"]) == 0
    assert "decode: 8" in capsys.readouterr().err


VARIANTS = ("deepseek-moe-16b", "dots1", "ling-lite", "phi3.5-moe", "grok-1", "dbrx", "arctic")


def test_variants_are_admitted_and_foreign_features_refused_by_name():
    """check_supported admits each MoE variant's config at its published
    widths, and refuses on an admitted variant a feature outside its set
    by the feature's name: dbrx with M-RoPE or MLA, grok with ALiBi,
    arctic with chunked attention, dots1 with a residual scale."""
    for name in VARIANTS:
        llama.check_supported(synthetic.CONFIGS[name](n_layer=2))
    for name, field, value, words in (("dbrx", "rope", RopeConfig(sections=(8, 8, 8, 8)),
                                       "M-RoPE"),
                                      ("dbrx", "n_lora_kv", 64, "MLA"),
                                      ("grok-1", "use_alibi", True, "ALiBi"),
                                      ("arctic", "swa_type", "chunked", "chunked SWA"),
                                      ("dots1", "residual_scale", 0.5, "residual scale")):
        cfg = synthetic.CONFIGS[name](n_layer=2)
        with pytest.raises(NotImplementedError, match=words):
            llama.check_supported(ModelConfig(**{**cfg.__dict__, field: value}))


# write_gguf geometries of the seven configs (each at n_embd 256, n_ff 512)
_SYNTH_CASES = {
    "deepseek-moe-16b": dict(arch="deepseek", n_head=4, n_head_kv=4, dense_lead=1, n_expert=4,
                             n_expert_used=2, n_ff_exp=64, shexp_ff=128,
                             metadata={"deepseek.expert_shared_count": 2}),
    "dots1": dict(arch="dots1", n_head=4, n_head_kv=4, qk_norm=True, dense_lead=1, n_expert=4,
                  n_expert_used=2, n_ff_exp=64, shexp_ff=128, probs_bias=True,
                  metadata={"dots1.expert_shared_count": 2, "dots1.expert_gating_func": 2}),
    "ling-lite": dict(arch="bailingmoe", n_expert=4, n_expert_used=2, n_ff_exp=64,
                      shexp_ff=128, metadata={"bailingmoe.expert_shared_count": 2}),
    "phi3.5-moe": dict(arch="phimoe", qkv_bias=True, norm_bias=True,
                       biases=("attn_output", "output"), n_expert=4, n_expert_used=2,
                       rope_factors=(np.linspace(1.0, 4.0, 32), np.ones(32)),
                       metadata={"phimoe.rope.scaling.original_context_length": 256}),
    "grok-1": dict(arch="grok", tied=True, post_norms=True, n_expert=8, n_expert_used=2,
                   post_norm_names=("attn_output_norm", "layer_output_norm")),
    "dbrx": dict(arch="dbrx", fused_qkv=True, ffn_norm="attn_output_norm", n_expert=4,
                 n_expert_used=2),
    "arctic": dict(arch="arctic", n_expert=4, n_expert_used=2, moe_dense=256),
}


@pytest.mark.parametrize("case", VARIANTS)
def test_synthetic_params_are_a_loaded_file(tmp_path, case):
    """make_synthetic_params at each variant's file geometry has the keys,
    kinds and shapes the port loads from a Q4_K_M file of that geometry
    whose kinds are utils/synthetic.py's table: the shared experts, the
    selection bias, phimoe's biases and rope tables, grok's renamed
    post-norms (8 experts: Q8_0 attn_k/attn_v, Q5_K attn_output), dbrx's
    one attn_qkv and renamed ffn_norm, arctic's dense FFN and
    ffn_norm_exps."""
    synthetic_matches_file(tmp_path, dict(_SYNTH_CASES[case], n_embd=256, n_ff=512))
