"""GGUF -> model params loader (llama only).

Counterpart of llamacog_tpu/models/loader.py::load_model for the llama
architecture: the tensors are read from the file and carried into the
port's tree by convert.from_reference, which keeps quantized weights in
wire format and applies the JAX loader's q/k/v and gate/up fusion.
"""

from __future__ import annotations

import torch

from ..convert import from_reference, gguf_tensors
from ..gguf import GGUFModelReader
from ..tokenizer import Vocab, build_tokenizer
from .config import ModelConfig


class Model:
    def __init__(self, config: ModelConfig, params: dict, vocab: Vocab | None, tokenizer):
        self.config = config
        self.params = params
        self.vocab = vocab
        self.tokenizer = tokenizer


def load_model(path: str, dtype=torch.bfloat16, device=None,
               with_tokenizer: bool = True) -> Model:
    """Load a llama GGUF onto `device` (None = CUDA; raises without one)."""
    reader = GGUFModelReader(path)
    try:
        cfg = ModelConfig.from_metadata(reader.metadata)
        params = from_reference(cfg, gguf_tensors(reader), device=device, dtype=dtype)
        vocab = tokenizer = None
        if with_tokenizer and "tokenizer.ggml.tokens" in reader.metadata:
            vocab = Vocab.from_metadata(reader.metadata)
            try:  # a vocab family the port lacks loads without a tokenizer
                tokenizer = build_tokenizer(vocab)
            except NotImplementedError:
                tokenizer = None
    finally:
        reader.close()
    return Model(cfg, params, vocab, tokenizer)
