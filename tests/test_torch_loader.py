"""The port's GGUF loader on vocab families it has no tokenizer for.

The JAX loader catches the tokenizer factory's NotImplementedError and
returns the model without a tokenizer (llamacog_tpu/models/loader.py); the
port does the same, so such a file still loads, and its CLI then says that
the model has no supported tokenizer. The port builds SPM and, where the
`regex` package is installed, BPE: a `gpt2` vocab, which every Llama-3 file
carries, loads with the BPE tokenizer in both packages, and with none in
the port on a host without `regex`; a family neither package knows loads
with none in both.
"""

import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llamacog_tpu.models.loader import load_model as jax_load_model
from llamacog_tpu.tokenizer import BpeTokenizer
from llamacog_tpu.utils.testing import make_tiny_llama_gguf
from llamacog_tpu_torch.models.loader import load_model
from llamacog_tpu_torch.tokenizer import BpeTokenizer as PortBpeTokenizer
from llamacog_tpu_torch.tools.cli import main as cli_main


def _gguf(tmp_path, family):
    return make_tiny_llama_gguf(str(tmp_path / f"{family}.gguf"),
                                extra_metadata={"tokenizer.ggml.model": family})


@pytest.mark.parametrize("family,jax_tokenizer", [("gpt2", BpeTokenizer), ("plamo2", None)])
def test_unported_vocab_family_loads_without_tokenizer(tmp_path, family, jax_tokenizer):
    path = _gguf(tmp_path, family)
    ref = jax_load_model(path, dtype=jnp.float32)
    got = load_model(path, dtype=torch.float32, device="cpu")
    assert got.vocab.model == family
    if jax_tokenizer is None:
        assert ref.tokenizer is None and got.tokenizer is None
    else:  # gpt2: the BPE tokenizer in both packages
        assert isinstance(ref.tokenizer, jax_tokenizer)
        assert isinstance(got.tokenizer, PortBpeTokenizer)
    assert got.vocab.tokens == ref.vocab.tokens
    assert set(got.params) == set(ref.params)
    for key in got.params:
        if key != "layers":
            np.testing.assert_array_equal(got.params[key].numpy(), np.asarray(ref.params[key]))
    assert len(got.params["layers"]) == len(ref.params["layers"])
    for lg, lr in zip(got.params["layers"], ref.params["layers"]):
        assert set(lg) == set(lr)
        for key in lg:
            np.testing.assert_array_equal(lg[key].numpy(), np.asarray(lr[key]))


def test_cli_reports_missing_tokenizer(tmp_path, capsys, monkeypatch):
    """A gpt2 vocab on a host without `regex` loads with no tokenizer."""
    monkeypatch.setitem(sys.modules, "regex", None)
    path = _gguf(tmp_path, "gpt2")
    assert cli_main(["-m", path, "-p", "hello", "-n", "2", "--device", "cpu",
                     "--dtype", "f32"]) == 1
    assert "no supported tokenizer" in capsys.readouterr().err
