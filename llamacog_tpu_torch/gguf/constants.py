"""GGUF file-format and ggml-type constants.

Wire-format spec: llama.cpp's ggml/include/gguf.h:1-33 (file layout),
llama.cpp's ggml/include/ggml.h:352-391 (type enum),
llama.cpp's ggml/src/ggml-common.h:167-418 (block layouts, sizes).
These are interoperability constants, re-derived from the published format.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

GGUF_MAGIC = b"GGUF"
GGUF_VERSION = 3
GGUF_DEFAULT_ALIGNMENT = 32
GGUF_KEY_GENERAL_ALIGNMENT = "general.alignment"

# K-quant superblock size.
QK_K = 256


class GGUFValueType(enum.IntEnum):
    UINT8 = 0
    INT8 = 1
    UINT16 = 2
    INT16 = 3
    UINT32 = 4
    INT32 = 5
    FLOAT32 = 6
    BOOL = 7
    STRING = 8
    ARRAY = 9
    UINT64 = 10
    INT64 = 11
    FLOAT64 = 12


class GGMLType(enum.IntEnum):
    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8
    Q8_1 = 9
    Q2_K = 10
    Q3_K = 11
    Q4_K = 12
    Q5_K = 13
    Q6_K = 14
    Q8_K = 15
    IQ2_XXS = 16
    IQ2_XS = 17
    IQ3_XXS = 18
    IQ1_S = 19
    IQ4_NL = 20
    IQ3_S = 21
    IQ2_S = 22
    IQ4_XS = 23
    I8 = 24
    I16 = 25
    I32 = 26
    I64 = 27
    F64 = 28
    IQ1_M = 29
    BF16 = 30
    TQ1_0 = 34
    TQ2_0 = 35


@dataclass(frozen=True)
class TypeTraits:
    """Block size (elements per block) and byte size per block."""

    block_size: int
    type_size: int

    @property
    def bits_per_weight(self) -> float:
        return self.type_size * 8.0 / self.block_size


# (block_size, type_size) per type; byte sizes follow the struct layouts in
# ggml-common.h (e.g. block_q4_K = 2*f16 + 12 scale bytes + 128 nibble bytes = 144).
GGML_TYPE_TRAITS: dict[GGMLType, TypeTraits] = {
    GGMLType.F32: TypeTraits(1, 4),
    GGMLType.F16: TypeTraits(1, 2),
    GGMLType.BF16: TypeTraits(1, 2),
    GGMLType.F64: TypeTraits(1, 8),
    GGMLType.I8: TypeTraits(1, 1),
    GGMLType.I16: TypeTraits(1, 2),
    GGMLType.I32: TypeTraits(1, 4),
    GGMLType.I64: TypeTraits(1, 8),
    GGMLType.Q4_0: TypeTraits(32, 2 + 16),
    GGMLType.Q4_1: TypeTraits(32, 4 + 16),
    GGMLType.Q5_0: TypeTraits(32, 2 + 4 + 16),
    GGMLType.Q5_1: TypeTraits(32, 4 + 4 + 16),
    GGMLType.Q8_0: TypeTraits(32, 2 + 32),
    GGMLType.Q8_1: TypeTraits(32, 4 + 32),
    GGMLType.Q2_K: TypeTraits(QK_K, 4 + QK_K // 16 + QK_K // 4),
    GGMLType.Q3_K: TypeTraits(QK_K, 2 + QK_K // 8 + QK_K // 4 + 12),
    GGMLType.Q4_K: TypeTraits(QK_K, 4 + 12 + QK_K // 2),
    GGMLType.Q5_K: TypeTraits(QK_K, 4 + 12 + QK_K // 8 + QK_K // 2),
    GGMLType.Q6_K: TypeTraits(QK_K, 2 + QK_K // 16 + 3 * QK_K // 4),
    GGMLType.Q8_K: TypeTraits(QK_K, 4 + QK_K + 2 * QK_K // 16),
    GGMLType.IQ2_XXS: TypeTraits(QK_K, 2 + QK_K // 4),
    GGMLType.IQ2_XS: TypeTraits(QK_K, 2 + QK_K // 4 + QK_K // 32),
    GGMLType.IQ2_S: TypeTraits(QK_K, 2 + QK_K // 4 + QK_K // 16),
    GGMLType.IQ3_XXS: TypeTraits(QK_K, 2 + 3 * QK_K // 8),
    GGMLType.IQ3_S: TypeTraits(QK_K, 2 + 13 * QK_K // 32 + QK_K // 64),
    GGMLType.IQ1_S: TypeTraits(QK_K, 2 + QK_K // 8 + QK_K // 16),
    GGMLType.IQ1_M: TypeTraits(QK_K, QK_K // 8 + QK_K // 16 + QK_K // 32),
    GGMLType.IQ4_NL: TypeTraits(32, 2 + 16),
    GGMLType.IQ4_XS: TypeTraits(QK_K, 2 + 2 + QK_K // 64 + QK_K // 2),
    GGMLType.TQ1_0: TypeTraits(QK_K, 2 + QK_K // 64 + (QK_K - 4 * QK_K // 64) // 5),
    GGMLType.TQ2_0: TypeTraits(QK_K, 2 + QK_K // 4),
}


def row_nbytes(ggml_type: GGMLType, n_elements: int) -> int:
    """Bytes of one contiguous row of `n_elements` of the given type."""
    tt = GGML_TYPE_TRAITS[ggml_type]
    if n_elements % tt.block_size != 0:
        raise ValueError(
            f"row of {n_elements} elements is not a multiple of "
            f"{ggml_type.name} block size {tt.block_size}"
        )
    return n_elements // tt.block_size * tt.type_size


# Model file-type enum ("general.file_type"), llama.h LLAMA_FTYPE_*.
class LlamaFtype(enum.IntEnum):
    ALL_F32 = 0
    MOSTLY_F16 = 1
    MOSTLY_Q4_0 = 2
    MOSTLY_Q4_1 = 3
    MOSTLY_Q8_0 = 7
    MOSTLY_Q5_0 = 8
    MOSTLY_Q5_1 = 9
    MOSTLY_Q2_K = 10
    MOSTLY_Q3_K_S = 11
    MOSTLY_Q3_K_M = 12
    MOSTLY_Q3_K_L = 13
    MOSTLY_Q4_K_S = 14
    MOSTLY_Q4_K_M = 15
    MOSTLY_Q5_K_S = 16
    MOSTLY_Q5_K_M = 17
    MOSTLY_Q6_K = 18
    MOSTLY_IQ2_XXS = 19
    MOSTLY_IQ2_XS = 20
    MOSTLY_Q2_K_S = 21
    MOSTLY_IQ3_XS = 22
    MOSTLY_IQ3_XXS = 23
    MOSTLY_IQ1_S = 24
    MOSTLY_IQ4_NL = 25
    MOSTLY_IQ3_S = 26
    MOSTLY_IQ3_M = 27
    MOSTLY_IQ2_S = 28
    MOSTLY_IQ2_M = 29
    MOSTLY_IQ4_XS = 30
    MOSTLY_IQ1_M = 31
    MOSTLY_BF16 = 32
    MOSTLY_TQ1_0 = 36
    MOSTLY_TQ2_0 = 37
