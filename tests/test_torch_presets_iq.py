"""llama.cpp's codebook presets (IQ4_NL, IQ4_XS, IQ3_XXS, IQ3_XS, IQ3_S,
IQ3_M, IQ2_M), loaded by both packages: the port's IQ4_NL, IQ4_XS, IQ3_XXS,
IQ3_S and IQ2_S wire kinds.

The checks of tests/test_torch_presets_dense.py (kinds against
utils/synthetic.py's table, both loaders bit for bit alike, the JAX
package's f32 greedy tokens) on the tiny random F32 GGUF of that file
(n_embd 256, n_ff 256, 2 layers, 4 query heads over 1 kv head), quantized
by the JAX package's quantizer to IQ4_NL, IQ4_XS, IQ3_XXS, IQ3_S and IQ2_M;
to IQ4_XS with an importance matrix the test writes; and an 8-expert model
(2 kv heads; one layer, as the codebook quantizer takes ~40 s a layer of
its expert stacks) in IQ3_XXS. The per-tensor table is also held against
the JAX quantizer's tensor_get_type at full depth with an importance
matrix, and below 4 query heads a kv head, where the importance matrix
moves IQ3_XXS's attn_v.
"""

import dataclasses
import struct

import numpy as np
import pytest

from llamacog_tpu_torch.gguf import GGUFModelReader
from llamacog_tpu_torch.utils import synthetic

from .test_torch_presets_dense import (PresetFiles, check_greedy_tokens, check_kinds,
                                       check_same_tensors, check_tensor_kinds_at)

PRESETS = ["IQ4_NL", "IQ4_XS", "IQ3_XXS", "IQ3_S", "IQ2_M"]
IQ_PRESETS = ["IQ4_NL", "IQ4_XS", "IQ3_XXS", "IQ3_XS", "IQ3_S", "IQ3_M", "IQ2_M"]


def write_imatrix(src: str, path: str, seed: int = 0) -> str:
    """An importance matrix for every weight of the GGUF at `src`, in the
    .dat layout tools/quantize.py::load_imatrix reads (entry count; per
    entry the name, ncall, the value count and the f32 values): one random
    positive value per input column (per expert and column for a stack)."""
    rng = np.random.default_rng(seed)
    reader = GGUFModelReader(src)
    entries = []
    for name in reader.names():
        shape = reader.tensor_info(name).shape
        if name.endswith(".weight") and len(shape) >= 2 and "norm" not in name:
            n = int(np.prod(shape[:-2], dtype=np.int64)) * shape[-1] if len(shape) == 3 \
                else shape[-1]
            entries.append((name, rng.uniform(0.1, 4.0, n).astype("<f4")))
    reader.close()
    with open(path, "wb") as f:
        f.write(struct.pack("<i", len(entries)))
        for name, vals in entries:
            raw = name.encode()
            f.write(struct.pack("<i", len(raw)) + raw + struct.pack("<ii", 1, vals.size))
            f.write(vals.tobytes())
    return path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return PresetFiles(tmp_path_factory.mktemp("presets_iq"), n_head=4, n_head_kv=1)


@pytest.fixture(scope="module")
def moe_files(tmp_path_factory):
    return PresetFiles(tmp_path_factory.mktemp("presets_iq_moe"), n_layer=1, n_head=4,
                       n_head_kv=2, n_expert=8, n_expert_used=2,
                       extra_metadata={"llama.expert_weights_norm": True})


@pytest.fixture(scope="module")
def imatrix_file(files):
    """IQ4_XS quantized with an importance matrix."""
    return files("IQ4_XS", write_imatrix(files.src, str(files.root / "imatrix.dat")))


@pytest.mark.parametrize("preset", PRESETS)
def test_file_kinds_are_the_synthetic_table(files, preset):
    check_kinds(files(preset), preset)


@pytest.mark.parametrize("preset", PRESETS)
def test_both_loaders_give_the_same_tensors(files, preset):
    check_same_tensors(files(preset))


@pytest.mark.parametrize("preset", PRESETS)
def test_engine_greedy_tokens_match_jax(files, preset):
    check_greedy_tokens(files(preset))


def test_moe_iq3_xxs_file(moe_files):
    """IQ3_XXS gate/up expert stacks (Q3_K down without an importance
    matrix), IQ2_S attn_q beside Q8_0 attn_k/attn_v, Q5_K attn_output."""
    path = moe_files("IQ3_XXS")
    check_kinds(path, "IQ3_XXS")
    check_same_tensors(path)
    check_greedy_tokens(path)


def test_imatrix_iq4_xs_file(imatrix_file):
    check_kinds(imatrix_file, "IQ4_XS", imatrix=True)
    check_same_tensors(imatrix_file)
    check_greedy_tokens(imatrix_file)


@pytest.mark.parametrize("preset", sorted(synthetic.PRESETS))
def test_tensor_kinds_with_an_importance_matrix_at_full_depth(preset):
    """The table with an importance matrix at Llama-3-8B and Mixtral-8x7B
    (32 layers) and at an 8B with one query head a kv head."""
    gqa1 = dataclasses.replace(synthetic.llama3_8b_config(), n_head_kv=32)
    check_tensor_kinds_at((synthetic.llama3_8b_config(), synthetic.mixtral_8x7b_config(), gqa1),
                          preset, imatrix=True)


@pytest.mark.parametrize("preset", IQ_PRESETS)
def test_tensor_kinds_below_four_query_heads_a_kv_head(preset):
    """Without an importance matrix at one query head a kv head (IQ3_XXS's
    attn_v is IQ3_S there, IQ3_XXS with one; the IQ3 and IQ4 attn_v rules
    ask for 4 or more)."""
    cfg = dataclasses.replace(synthetic.llama3_8b_config(), n_head_kv=32)
    check_tensor_kinds_at((cfg,), preset, imatrix=False)
