"""The deepseek2 family in the port (MLA in its decompressed form, leading
dense layers, shared experts without a gate, softmax or sigmoid routing),
held against the JAX package.

Tiny random GGUFs (tests/test_torch_arch_qwen.py::write_gguf, 3 layers:
one dense, two MoE) are loaded by both packages as f32 models; the prefill
logits within 1e-4 of max |logit| and 16 greedy tokens equal, with the
dense and the q8_0 cache (K 48 = 32 nope + 16 rope, V 32: Dk != Dv). The
cases: DeepSeek-V2-Lite style (no q LoRA, 2 shared experts, softmax top-k,
YaRN), all Q8_0, so the experts take the sparse routes (a 12-token prefill
has 36 (token, slot) rows: the grouped path); V2 style (the q LoRA,
routed scale 16), F32; V3 style (sigmoid gating, the exp_probs_b selection
bias, top-k norm and scale 2.5), Q8_0.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llamacog_tpu.gguf import GGMLType
from llamacog_tpu.models import llama as jax_llama
from llamacog_tpu.models.loader import load_model as jax_load_model
from llamacog_tpu_torch.models import llama
from llamacog_tpu_torch.models.config import ModelConfig, RopeConfig
from llamacog_tpu_torch.models.loader import load_model
from llamacog_tpu_torch.ops.cuda import qmm_id
from llamacog_tpu_torch.runtime import engine as engine_mod
from llamacog_tpu_torch.utils import synthetic

from .test_torch_arch_qwen import PROMPT, TOL, check_same_run, load_both, write_gguf

MLA = {"kv_lora": 64, "q_lora": 0, "rope": 16, "nope": 32, "v": 32}
YARN = {"deepseek2.rope.scaling.type": "yarn", "deepseek2.rope.scaling.factor": 40.0,
        "deepseek2.rope.scaling.original_context_length": 4096,
        "deepseek2.rope.scaling.yarn_log_multiplier": 0.0707}
BASE = dict(arch="deepseek2", n_layer=3, n_head=4, n_head_kv=4, n_ff=96, mla=MLA,
            dense_lead=1, n_expert=8, n_expert_used=3, n_ff_exp=32, shexp_ff=64)
CASES = {
    "v2-lite": dict(BASE, kind=lambda n: GGMLType.Q8_0,
                    metadata={**YARN, "deepseek2.expert_shared_count": 2}),
    "v2": dict(BASE, mla={**MLA, "q_lora": 48},
               metadata={**YARN, "deepseek2.expert_shared_count": 2,
                         "deepseek2.expert_weights_scale": 16.0}),
    "v3": dict(BASE, kind=lambda n: GGMLType.Q8_0, probs_bias=True,
               metadata={**YARN, "deepseek2.expert_shared_count": 2,
                         "deepseek2.expert_gating_func": 2,
                         "deepseek2.expert_weights_norm": True,
                         "deepseek2.expert_weights_scale": 2.5}),
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("arch_deepseek")
    return {name: write_gguf(str(root / f"{name}.gguf"), **case)
            for name, case in CASES.items()}


@pytest.mark.parametrize("kv_type", ["dense", "q8_0"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_greedy_tokens_match_jax(files, case, kv_type):
    check_same_run(files[case], kv_type)


def test_config_and_keys_follow_the_jax_loader(files):
    """Every head keeps its own decompressed K/V (n_head_kv = n_head), YaRN's
    mscale is folded into the attention scale, and each layer's keys are
    the JAX loader's: the dense lead layer's gate_up, the MoE layers'
    router, stacks and ungated shared expert, the q LoRA's attn_q_b_proj
    apart from the q bias key attn_q_b, the V3 selection bias in f32."""
    for case, extra in (("v2-lite", {"attn_q"}), ("v2", {"attn_q_a", "attn_q_b_proj"}),
                        ("v3", {"exp_probs_b"})):
        ref = jax_load_model(files[case], with_tokenizer=False, dtype=jnp.float32)
        got = load_model(files[case], dtype=torch.float32, device="cpu", with_tokenizer=False)
        cfg = got.config
        assert (cfg.n_head_kv, cfg.head_dim_k, cfg.head_dim_v) == (4, 48, 32)
        assert cfg.kq_scale == pytest.approx(ref.config.kq_scale)
        assert cfg.kq_scale == pytest.approx((1 + 0.0707 * np.log(40)) ** 2 / np.sqrt(48))
        for il in range(3):
            assert set(got.params["layers"][il]) == set(ref.params["layers"][il]), (case, il)
        assert "ffn_gate_up" in got.params["layers"][0]
        moe = got.params["layers"][1]
        assert extra <= set(moe) and "attn_q_b" not in moe and "ffn_gate_inp_shexp" not in moe
        assert {"attn_kv_a_mqa", "attn_kv_a_norm", "attn_kv_b", "ffn_gate_inp",
                "ffn_up_shexp"} <= set(moe)
        if case == "v3":
            assert moe["exp_probs_b"].dtype == torch.float32


def test_context_shift_matches_jax(files):
    """shift_row on an MLA cache rotates the rope part, the first 16 dims of
    each key (the layout's rope part first), as the JAX shift does: the
    logits after the shift and the greedy tokens on top of it equal the
    JAX engine's."""
    ref, eng, _ = load_both(files["v2-lite"], batch_size=1, max_seq=256)
    ref.prefill(PROMPT)
    eng.prefill(PROMPT)
    ref.shift_row(0, 3, 5)
    eng.shift_row(0, 3, 5)
    want = np.asarray(ref.decode_one(np.array([7])))
    got = eng.decode_one(np.array([7]))
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()
    first = np.array([int(np.argmax(want[0]))])
    np.testing.assert_array_equal(eng.decode_greedy_tokens(first, 8),
                                  np.asarray(ref.decode_greedy_tokens(first, 8)))


def test_router_takes_top_k_over_all_experts():
    """DeepSeek-V2 routes group-limited in llama.cpp's source model (8
    groups, the top 3 of them); the JAX router takes top-k over all experts
    and has no group keys, and the port keeps that parity: with the best
    three experts in one group of four, both pick those three."""
    n_exp, k = 8, 3
    cfg = synthetic.deepseek_v2_config(n_layer=2)
    cfg = ModelConfig(**{**cfg.__dict__, "n_expert": n_exp, "n_expert_used": k, "n_embd": n_exp,
                         "metadata": {"deepseek2.expert_group_count": 2,
                                      "deepseek2.expert_group_used_count": 1}})
    logits = np.array([[0.1, 0.2, 3.0, 2.9, 0.0, 2.8, -1.0, 0.3]], np.float32)
    layer = {"ffn_gate_inp": torch.eye(n_exp)}
    top_i, gate_w = llama._moe_router(layer, torch.from_numpy(logits), cfg)
    ref_i, ref_w = jax_llama._moe_router({"ffn_gate_inp": jnp.eye(n_exp)}, jnp.asarray(logits),
                                         cfg)
    assert sorted(top_i[0].tolist()) == sorted(np.asarray(ref_i)[0].tolist()) == [2, 3, 5]
    np.testing.assert_allclose(gate_w.numpy(), np.asarray(ref_w), rtol=1e-6)
    assert float(gate_w.sum()) == pytest.approx(
        16.0 * float(torch.softmax(torch.from_numpy(logits), -1)[0, [2, 3, 5]].sum()), rel=1e-6)


def test_prefill_keeps_2048_token_steps():
    """The grouped GEMM takes 1024 token tiles: a 2048-token step of top 6
    pads to 2048 x 6 + n_expert x 15 rows, 828 tiles of 16 for DeepSeek-V2-
    Lite's 64 experts and 918 for DeepSeek-V2's 160, so both keep the
    2048-token prefill step (the 128-expert Qwen3-30B-A3B takes 512)."""
    assert qmm_id.RAGGED_TILE == 16 and qmm_id.RAGGED_MAX_TILES == 1024
    for cfg, tiles in ((synthetic.deepseek_v2_lite_config(), 828),
                       (synthetic.deepseek_v2_config(), 918)):
        assert -(-(2048 * cfg.n_expert_used + cfg.n_expert * 15) // 16) == tiles
        assert engine_mod.prefill_chunk(cfg) == 2048
    assert engine_mod.prefill_chunk(synthetic.qwen3_30b_a3b_config()) == 512


def test_phi2_and_absorbed_mla_are_refused_by_name(files, tmp_path):
    """check_supported refuses an arch outside the ported families by name
    (jamba; phi2 is admitted) and every feature outside the admitted
    families by name,
    and a newer llama.cpp DeepSeek conversion (absorbed MLA: attn_k_b /
    attn_v_b, no attn_kv_b), which the JAX loader has no keys for, is
    refused naming its tensors."""
    cfg = load_model(files["v2-lite"], device="cpu", with_tokenizer=False).config
    with pytest.raises(NotImplementedError, match="architecture 'jamba' is not ported yet"):
        llama.check_supported(ModelConfig(**{**cfg.__dict__, "arch": "jamba"}))
    llama.check_supported(synthetic.phi2_config(n_layer=2))
    # every feature outside the admitted families, on an admitted arch
    for field, value, words in (("nonparam_norms", True, "non-parametric layer norm"),
                                ("norm_type", "layer", "layer norm"),
                                ("parallel_residual", True, "parallel residual"),
                                ("logit_scale", 0.5, "logit scale"),
                                ("n_no_rope_layer_step", 4, "NoPE layers"),
                                ("use_attn_temp", True, "attention temperature"),
                                ("rope", RopeConfig(sections=(8, 8, 8, 8)), "M-RoPE"),
                                ("post_norm_only", True, "post-norm-only"),
                                ("qk_norm_layer", True, "whole projection"),
                                ("residual_scale", 0.5, "residual scale"),
                                ("attn_clamp", 8.0, "clamp_kqv"),
                                ("causal", False, "non-causal"),
                                ("moe_every_n_layers", 2, "interleaved MoE")):
        with pytest.raises(NotImplementedError, match=words):
            llama.check_supported(ModelConfig(**{**cfg.__dict__, field: value}))
    # the lifted features stay refused outside their families
    qwen = synthetic.qwen3_8b_config(n_layer=2)
    for field, value, words in (("n_lora_kv", 64, "MLA"), ("n_expert_shared", 2, "shared")):
        with pytest.raises(NotImplementedError, match=words):
            llama.check_supported(ModelConfig(**{**qwen.__dict__, field: value}))
    path = write_gguf(str(tmp_path / "absorbed.gguf"), **dict(
        CASES["v2"], extra_tensors={"blk.0.attn_k_b.weight": np.zeros((4, 64, 32)),
                                    "blk.0.attn_v_b.weight": np.zeros((4, 32, 64))}))
    with pytest.raises(NotImplementedError, match="attn_k_b.weight / attn_v_b.weight"):
        load_model(path, device="cpu", with_tokenizer=False)

