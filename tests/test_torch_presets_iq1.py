"""llama.cpp's 1-bit presets IQ1_S and IQ1_M and the ternary (BitNet
b1.58) presets TQ1_0 and TQ2_0, loaded by both packages: the port's IQ1_S,
IQ1_M, TQ1_0 and TQ2_0 wire kinds.

The checks of tests/test_torch_presets_dense.py (kinds against
utils/synthetic.py's table, both loaders bit for bit alike, the JAX
package's f32 greedy tokens) on the tiny random F32 GGUF of that file
(n_embd 256, n_ff 256, 2 layers, 4 query heads over 1 kv head), quantized
by the JAX package's quantizer to each preset (the 1-bit ones attn_output
IQ2_XXS, token_embd Q2_K, ffn_down of the first n_layer / 8 layers Q2_K;
the ternary ones token_embd Q4_K); and an 8-expert model (2 kv heads; one
layer) in IQ1_M: IQ1_M expert stacks beside Q4_K attn_k and attn_v and a
Q5_K attn_output.
"""

import pytest

from .test_torch_presets_dense import (PresetFiles, check_greedy_tokens, check_kinds,
                                       check_same_tensors)

PRESETS = ["IQ1_S", "IQ1_M", "TQ1_0", "TQ2_0"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return PresetFiles(tmp_path_factory.mktemp("presets_iq1"), n_head=4, n_head_kv=1)


@pytest.fixture(scope="module")
def moe_files(tmp_path_factory):
    return PresetFiles(tmp_path_factory.mktemp("presets_iq1_moe"), n_layer=1, n_head=4,
                       n_head_kv=2, n_expert=8, n_expert_used=2,
                       extra_metadata={"llama.expert_weights_norm": True})


@pytest.mark.parametrize("preset", PRESETS)
def test_file_kinds_are_the_synthetic_table(files, preset):
    check_kinds(files(preset), preset)


@pytest.mark.parametrize("preset", PRESETS)
def test_both_loaders_give_the_same_tensors(files, preset):
    check_same_tensors(files(preset))


@pytest.mark.parametrize("preset", PRESETS)
def test_engine_greedy_tokens_match_jax(files, preset):
    check_greedy_tokens(files(preset))


def test_moe_iq1_m_file(moe_files):
    path = moe_files("IQ1_M")
    check_kinds(path, "IQ1_M")
    check_same_tensors(path)
    check_greedy_tokens(path)
