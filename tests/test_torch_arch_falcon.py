"""The Falcon family in the port (falcon, 7B and 40B style), held against
the JAX package.

Tiny random GGUFs (tests/test_torch_arch_qwen.py::write_gguf), 2 layers:
Falcon-7B style (one attn_qkv, no biases on the products, layer norms with
biases, an ungated GELU FFN, one norm feeding the attention and the FFN in
parallel), multi-query: 8 query heads over one kv head (rep 8 here, 71 in
Falcon-7B; the plain path takes any rep), all Q8_0; Falcon-40B style
(attn_norm_2 feeds the attention, attn_norm the FFN; 8 query heads over 2);
and a 7B-style file 224 wide (7 heads of 32 over one) in a Q4_K_M file's
kinds, where 256 does not divide K 224, so its weights take llama.cpp's
32-weight-block fallback kinds (utils/synthetic.py::tensor_kinds), as
Falcon-7B's K 4544 does. The prefill logits within 1e-4 of max |logit|
and 16 greedy tokens equal, f32 models, with the dense and the q8_0 cache;
the bf16 prefill logits within 3e-2 of max |logit|.
"""

import pytest

import jax.numpy as jnp

from llamacog_tpu.gguf import GGMLType
from llamacog_tpu.models.loader import load_model as jax_load_model
from llamacog_tpu_torch.models.loader import load_model
from llamacog_tpu_torch.quant.wire import WireTensor
from llamacog_tpu_torch.utils import synthetic

from .test_torch_arch_phi2 import bf16_prefill_close
from .test_torch_arch_qwen import check_same_run, synthetic_matches_file, write_gguf

FALCON = dict(arch="falcon", n_embd=256, n_head=8, n_head_kv=1, head_dim=32, n_ff=512,
              fused_qkv=True, ffn_norm=False, ffn_gate=False, norm_bias=True)
K224 = dict(FALCON, n_embd=224, n_head=7, n_ff=512)


def _q4_k_m_fitted(name):
    """A Q4_K_M file's kinds at K 224 (tensor_kinds' rule for each tensor,
    fitted to its row length as llama.cpp fits them)."""
    if name == "output.weight":
        return GGMLType.Q8_0
    part = name.split(".")[-2]
    kind = {"attn_qkv": "Q5_K", "ffn_down": "Q6_K"}.get(part, "Q4_K")
    k = 512 if "ffn_down" in name else 224
    return GGMLType[synthetic.fit_kind(kind, k)]


CASES = {
    "falcon-7b": dict(FALCON, kind=lambda n: GGMLType.Q8_0),
    "falcon-40b": dict(FALCON, n_head_kv=2, attn_norm_2=True),
    "falcon-7b K 224": dict(K224, kind=_q4_k_m_fitted),
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("arch_falcon")
    return {name: write_gguf(str(root / f"{name.replace(' ', '_')}.gguf"), **case)
            for name, case in CASES.items()}


@pytest.mark.parametrize("case,kv_type", [("falcon-7b", "dense"), ("falcon-7b", "q8_0"),
                                          ("falcon-40b", "dense"), ("falcon-40b", "q8_0"),
                                          ("falcon-7b K 224", "dense")])
def test_tokens_match_jax(files, case, kv_type):
    check_same_run(files[case], kv_type)


def test_falcon_bf16_prefill_close_to_jax(files):
    bf16_prefill_close(files["falcon-7b"])


def test_keys_and_kinds_follow_the_jax_loader(files):
    """The JAX loader's keys: attn_norm_2 on the 40B style alone, no
    ffn_norm and no ffn_gate; the K-224 file's 32-weight-block kinds (Q5_1
    attn_qkv, Q5_0 attn_output and ffn_up) and its K-512 ffn_down a K-quant,
    as Falcon-7B's K-18176 ffn_down keeps Q4_K/Q6_K."""
    for case in CASES:
        ref = jax_load_model(files[case], with_tokenizer=False, dtype=jnp.float32).params
        got = load_model(files[case], device="cpu", with_tokenizer=False).params
        assert set(got) == set(ref), case
        assert set(got["layers"][0]) == set(ref["layers"][0]), case
        layer = got["layers"][0]
        assert ("attn_norm_2" in layer) is (case == "falcon-40b"), case
        assert not {"ffn_norm", "ffn_gate", "attn_qkv_b"} & set(layer), case
    layer = load_model(files["falcon-7b K 224"], device="cpu",
                       with_tokenizer=False).params["layers"][0]
    kinds = {k: w.kind for k, w in layer.items() if isinstance(w, WireTensor)}
    assert kinds == {"attn_qkv": "Q5_1", "attn_output": "Q5_0", "ffn_up": "Q5_0",
                     "ffn_down": "Q6_K"}


@pytest.mark.parametrize("case", ["falcon-7b", "falcon-40b"])
def test_synthetic_params_are_a_loaded_file(tmp_path, case):
    """make_synthetic_params at a Falcon file's geometry, 224 wide as the
    K-4544 rows of Falcon-7B are off the 256-weight runs, is that file
    loaded in the kinds of utils/synthetic.py's table (the runs on the card
    stand for such files): the norm biases, attn_norm_2 of the 40B style,
    the fallback kinds."""
    geo = dict(K224, n_head_kv=1 if case == "falcon-7b" else 7,
               attn_norm_2=case == "falcon-40b")
    synthetic_matches_file(tmp_path, geo)
