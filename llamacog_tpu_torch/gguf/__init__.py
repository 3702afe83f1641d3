from .constants import (
    GGML_TYPE_TRAITS,
    GGUF_DEFAULT_ALIGNMENT,
    GGUF_MAGIC,
    GGUF_VERSION,
    QK_K,
    GGMLType,
    GGUFValueType,
    LlamaFtype,
    TypeTraits,
    row_nbytes,
)
from .reader import GGUFFormatError, GGUFModelReader, GGUFReader, TensorInfo

__all__ = [
    "GGML_TYPE_TRAITS",
    "GGUF_DEFAULT_ALIGNMENT",
    "GGUF_MAGIC",
    "GGUF_VERSION",
    "QK_K",
    "GGMLType",
    "GGUFValueType",
    "LlamaFtype",
    "TypeTraits",
    "row_nbytes",
    "GGUFFormatError",
    "GGUFModelReader",
    "GGUFReader",
    "TensorInfo",
]
