"""llama.cpp's weight presets other than Q4_K_M on an 8-expert model,
loaded by both packages: the expert stacks take every wire kind (Q5_K and
Q8_0 experts among them).

The checks of tests/test_torch_presets_dense.py on a tiny random F32 GGUF of
8 experts, top 2 (n_embd 256, n_ff 256, 2 layers), quantized by the JAX
package's quantizer to each preset: llama.cpp's rules give an 8-expert
model Q8_0 attn_k and attn_v and, under the K presets below Q5_K_M, Q5_K
attn_output, so the loaders keep the attention weights apart.
"""

import pytest

from .test_torch_presets_dense import (PresetFiles, check_greedy_tokens, check_kinds,
                                       check_same_tensors)
from .test_torch_arch_qwen import one_torch_thread  # noqa: F401 (an autouse fixture)

PRESETS = ["Q5_K_M", "Q8_0", "Q3_K_M", "Q2_K"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return PresetFiles(tmp_path_factory.mktemp("presets_moe"), n_head=4, n_head_kv=2,
                       n_expert=8, n_expert_used=2,
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
