"""Chameleon and BitNet in the port, held against the JAX package.

Tiny random GGUFs, 2 layers. Chameleon by the JAX package's oracle spec
(tests/test_e2e_oracle.py::ARCH_ORACLE_SPECS, written by
make_tiny_arch_gguf: a layer norm of each q and k head with [heads,
head_dim] weights and biases before rope, at eps 0; a vocab of 8448 ids,
past 8196, so the image tokens [4, 8196) take -FLT_MAX in the logits), and
its swin ordering (chameleon.swin_norm: no pre-norms, attn_norm and
ffn_norm applied to the branch outputs, the JAX loader's rename to
attn_post_norm and ffn_post_norm). BitNet by its oracle spec (F32: rms
sub-norms before attn_output and ffn_down, a scale on each product, tied
head) and by tests/test_torch_arch_qwen.py::write_gguf with scales that
are none of them 1, as F32 and quantized by the JAX quantizer to TQ2_0 (the
ternary kind BitNet's files were made for; n_embd and n_ff 256). The f32
prefill logits within 1e-4 of max |logit| and 16 greedy tokens equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llamacog_tpu.gguf import GGMLType, GGUFModelReader
from llamacog_tpu.models.loader import load_model as jax_load_model
from llamacog_tpu.tools.quantize import quantize_model
from llamacog_tpu.utils.testing import make_tiny_arch_gguf
from llamacog_tpu_torch.models import llama
from llamacog_tpu_torch.models.config import ModelConfig
from llamacog_tpu_torch.models.loader import load_model
from llamacog_tpu_torch.runtime.engine import Engine
from llamacog_tpu_torch.utils import synthetic

from .test_e2e_oracle import ARCH_ORACLE_SPECS
from .test_torch_arch_qwen import PROMPT, check_same_run, synthetic_matches_file, write_gguf
from .test_torch_arch_qwen import one_torch_thread  # noqa: F401 (an autouse fixture)

SPECS = {"chameleon": ("chameleon", ARCH_ORACLE_SPECS["chameleon"]),
         "chameleon swin": ("chameleon", {**ARCH_ORACLE_SPECS["chameleon"],
                                          "extra_metadata": {"chameleon.swin_norm": True}}),
         "bitnet": ("bitnet", ARCH_ORACLE_SPECS["bitnet"])}
BITNET = dict(arch="bitnet", bitnet=True, tied=True, n_embd=256, n_ff=256, n_head=4,
              n_head_kv=4, seed=5)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("arch_chameleon_bitnet")
    out = {name: make_tiny_arch_gguf(str(root / f"{name.replace(' ', '_')}.gguf"), arch,
                                     seed=3, **spec)
           for name, (arch, spec) in SPECS.items()}
    out["bitnet scaled"] = write_gguf(str(root / "bitnet_scaled.gguf"), **BITNET)
    out["bitnet TQ2_0"] = str(root / "bitnet_tq2_0.gguf")
    quantize_model(out["bitnet scaled"], out["bitnet TQ2_0"], "TQ2_0")
    return out


@pytest.mark.parametrize("case,kv_type", [
    ("chameleon", "dense"), ("chameleon", "q8_0"), ("chameleon swin", "dense"),
    ("bitnet", "dense"), ("bitnet scaled", "dense"), ("bitnet TQ2_0", "dense"),
    ("bitnet TQ2_0", "q8_0")])
def test_greedy_tokens_match_jax(files, case, kv_type):
    check_same_run(files[case], kv_type)


def test_image_tokens_are_suppressed(files, tmp_path):
    """The prefill's logits of ids 4-8195 are -FLT_MAX, the others finite:
    a chameleon vocab past 8196 ids; a chameleon file of 256 ids is left as
    it is (the JAX rule), and matches the JAX package."""
    m = load_model(files["chameleon"], dtype=torch.float32, device="cpu", with_tokenizer=False)
    assert m.config.n_vocab == 8448
    eng = Engine(m.params, m.config, max_seq=64, dtype=torch.float32, device="cpu")
    last = eng.prefill(PROMPT)
    flt_max = float(np.finfo(np.float32).max)
    assert (last[4:8196] == -flt_max).all()
    assert np.isfinite(last[:4]).all() and (np.abs(last[8196:]) < 1e30).all()
    small = make_tiny_arch_gguf(str(tmp_path / "small.gguf"), "chameleon", seed=3,
                                qk_norm_layer=True)
    check_same_run(small)
    m = load_model(small, dtype=torch.float32, device="cpu", with_tokenizer=False)
    out = Engine(m.params, m.config, max_seq=64, dtype=torch.float32, device="cpu").prefill(
        PROMPT)
    assert (np.abs(out) < 1e30).all()


def test_keys_and_config_follow_the_jax_loader(files):
    """The JAX loader's keys and dtypes: chameleon's per-head norms
    [heads, head_dim] with their biases (f32), the swin file's attn_norm and
    ffn_norm renamed to its post-norms (no pre-norm left) and norm eps 0;
    bitnet's q/k/v and gate/up apart (no fusion past a scale), its scales
    in the model dtype, its sub-norms f32."""
    for case in files:
        for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
            ref = jax_load_model(files[case], with_tokenizer=False, dtype=jdtype)
            got = load_model(files[case], dtype=dtype, device="cpu", with_tokenizer=False)
            assert set(got.params) == set(ref.params), case
            for lg, lr in zip(got.params["layers"], ref.params["layers"]):
                assert set(lg) == set(lr), case
                for key, w in lg.items():
                    if isinstance(w, torch.Tensor):
                        assert str(w.dtype).split(".")[-1] == str(lr[key].dtype), (case, key)
                        assert tuple(w.shape) == tuple(lr[key].shape), (case, key)
            for f in ("norm_eps", "post_norm_only", "post_norms", "qk_norm_layer"):
                assert getattr(got.config, f) == getattr(ref.config, f), (case, f)
    cham = load_model(files["chameleon swin"], device="cpu", with_tokenizer=False)
    layer = cham.params["layers"][0]
    assert {"attn_post_norm", "ffn_post_norm", "attn_q_norm_b", "attn_k_norm_b"} <= set(layer)
    assert not {"attn_norm", "ffn_norm"} & set(layer)
    assert cham.config.norm_eps == 0.0 and layer["attn_q_norm"].shape == (4, 16)
    bit = load_model(files["bitnet TQ2_0"], device="cpu", with_tokenizer=False)
    layer = bit.params["layers"][1]
    assert {"attn_q", "attn_k", "attn_v", "ffn_gate", "ffn_up", "attn_sub_norm",
            "ffn_sub_norm"} <= set(layer)
    assert {layer[k].kind for k in ("attn_q", "ffn_gate", "ffn_down")} == {"TQ2_0"}
    scales = [float(layer[f"{k}_scale"]) for k in ("attn_q", "attn_k", "attn_v", "attn_output",
                                                   "ffn_gate", "ffn_up", "ffn_down")]
    assert all(abs(s - 1.0) > 0.05 for s in scales)
    assert layer["attn_q_scale"].dtype == torch.bfloat16


def test_bitnet_tq2_0_file_kinds_are_the_synthetic_table(files):
    """The JAX quantizer's TQ2_0 file has utils/synthetic.py's kinds for its
    config (TQ2_0 products at K 256, the tied embedding's Q6_K)."""
    reader = GGUFModelReader(files["bitnet TQ2_0"])
    try:
        cfg = ModelConfig.from_metadata(reader.metadata)
        cfg.tie_word_embeddings = True
        table = synthetic.tensor_kinds(cfg, "TQ2_0")
        assert GGMLType(reader.tensor_info("token_embd.weight").ggml_type).name == \
            table["token_embd"]
        for il in range(cfg.n_layer):
            for key, kind in table["layers"][il].items():
                got = reader.tensor_info(f"blk.{il}.{key}.weight").ggml_type
                assert GGMLType(got).name == kind, (il, key)
    finally:
        reader.close()


def test_the_synthetic_configs_are_admitted():
    """Chameleon-7B, the swin Chameleon-30B and BitNet b1.58-large at their
    published widths; BitNet's ternary rows (K 1536, 4096) take TQ1_0 and
    TQ2_0 with no fallback; chameleon's features stay refused elsewhere."""
    for name in ("chameleon-7b", "chameleon-30b", "bitnet-b1.58-large"):
        llama.check_supported(synthetic.CONFIGS[name](n_layer=2))
    assert synthetic.chameleon_30b_config(2).post_norm_only
    assert not synthetic.chameleon_7b_config(2).post_norm_only
    cfg = synthetic.bitnet_b1_58_large_config(n_layer=2)
    for preset in ("TQ1_0", "TQ2_0"):
        lk = synthetic.tensor_kinds(cfg, preset)["layers"][0]
        assert {lk[k] for k in ("attn_q", "attn_k", "attn_v", "attn_output", "ffn_gate",
                                "ffn_up", "ffn_down")} == {preset}
    qwen = synthetic.qwen3_8b_config(n_layer=2)
    for field, words in (("qk_norm_layer", "per-head layer norms"),
                         ("post_norm_only", "post-norm-only")):
        with pytest.raises(NotImplementedError, match=words):
            llama.check_supported(ModelConfig(**{**qwen.__dict__, field: True}))


_SYNTH = {"chameleon": dict(arch="chameleon", qk_norm="layer", n_head=4, n_head_kv=4),
          "chameleon swin": dict(arch="chameleon", qk_norm="layer", n_head=4, n_head_kv=2,
                                 attn_norm=False, ffn_norm=False, post_norms=True,
                                 post_norm_names=("attn_norm", "ffn_norm"),
                                 metadata={"chameleon.swin_norm": True}),
          "bitnet": dict(arch="bitnet", bitnet=True, tied=True, n_head=4, n_head_kv=4)}


@pytest.mark.parametrize("case", sorted(_SYNTH))
def test_synthetic_params_are_a_loaded_file(tmp_path, case):
    """make_synthetic_params at each geometry is its Q4_K_M file loaded:
    chameleon's per-head layer norms and their biases (q+k never fuse past
    them), the swin file's post-norms, bitnet's products apart with their
    scales and its two sub-norms."""
    synthetic_matches_file(tmp_path, dict(_SYNTH[case], n_embd=256, n_ff=512))
