"""llama.cpp's 2-bit presets IQ2_XXS and IQ2_S (whose body is the kind
IQ2_XS), loaded by both packages: the port's IQ2_XXS and IQ2_XS wire kinds.

The checks of tests/test_torch_presets_dense.py (kinds against
utils/synthetic.py's table, both loaders bit for bit alike, the JAX
package's f32 greedy tokens) on the tiny random F32 GGUF of that file
(n_embd 256, n_ff 256, 2 layers, 4 query heads over 1 kv head), quantized
by the JAX package's quantizer (~30 s a file: the 2-bit codebook search is
slow; tests/test_torch_presets_iq1.py holds the 1-bit and ternary presets,
so the two files run on different workers). The per-tensor table of every
1-2 bit and ternary preset is also held against the JAX quantizer's
tensor_get_type at Llama-3-70B's full depth and geometry (64 query heads
over 8 kv heads, 80 layers), and below 4 query heads a kv head, where
llama.cpp's 1-2 bit rules give attn_v IQ3_S or Q2_K.
"""

import dataclasses

import pytest

from llamacog_tpu_torch.utils import synthetic

from .test_torch_presets_dense import (PresetFiles, check_greedy_tokens, check_kinds,
                                       check_same_tensors, check_tensor_kinds_at)

PRESETS = ["IQ2_XXS", "IQ2_S"]
LOW_PRESETS = ["IQ2_XXS", "IQ2_XS", "IQ2_S", "IQ2_M", "IQ1_S", "IQ1_M", "TQ1_0", "TQ2_0"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return PresetFiles(tmp_path_factory.mktemp("presets_iq2"), n_head=4, n_head_kv=1)


@pytest.mark.parametrize("preset", PRESETS)
def test_file_kinds_are_the_synthetic_table(files, preset):
    check_kinds(files(preset), preset)


@pytest.mark.parametrize("preset", PRESETS)
def test_both_loaders_give_the_same_tensors(files, preset):
    check_same_tensors(files(preset))


@pytest.mark.parametrize("preset", PRESETS)
def test_engine_greedy_tokens_match_jax(files, preset):
    check_greedy_tokens(files(preset))


def test_iq2_s_preset_has_an_iq2_xs_body():
    """The preset named IQ2_S quantizes its body to the kind IQ2_XS
    (llama.cpp's ftype table), with IQ3_S token_embd and first ffn_down
    layers as IQ2_M's rules give."""
    kinds = synthetic.tensor_kinds(synthetic.llama3_8b_config(), "IQ2_S")
    assert synthetic.PRESETS["IQ2_S"] == "IQ2_XS" and kinds["token_embd"] == "IQ3_S"
    assert [lk["ffn_down"] for lk in kinds["layers"][:5]] == ["IQ3_S"] * 4 + ["IQ2_XS"]
    assert {lk["ffn_gate"] for lk in kinds["layers"]} == {"IQ2_XS"}


@pytest.mark.parametrize("imatrix", [False, True])
@pytest.mark.parametrize("preset", LOW_PRESETS)
def test_tensor_kinds_at_70b_full_depth(preset, imatrix):
    """The table at Llama-3-70B (80 layers, 8 query heads a kv head)."""
    check_tensor_kinds_at((synthetic.llama3_70b_config(),), preset, imatrix)


@pytest.mark.parametrize("preset", LOW_PRESETS)
def test_tensor_kinds_below_four_query_heads_a_kv_head(preset):
    """At one and two query heads a kv head (8B widths), where attn_v
    leaves Q4_K (IQ3_S for IQ2_S and IQ2_M, Q2_K for the other 1-2 bit
    presets, the body kind for the ternary ones), and on a 4-expert model
    of two, whose attn_v stays Q4_K and whose attn_k and attn_output take
    the rules of a model without 8 experts."""
    base = synthetic.llama3_8b_config()
    cfgs = (dataclasses.replace(base, n_head_kv=32), dataclasses.replace(base, n_head_kv=16),
            dataclasses.replace(synthetic.mixtral_8x7b_config(), n_head_kv=16, n_expert=4))
    check_tensor_kinds_at(cfgs, preset, imatrix=False)
