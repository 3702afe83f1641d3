"""The port's byte-level BPE tokenizer (llamacog_tpu_torch/tokenizer/bpe.py)
against the JAX package's, on the CPU.

A `gpt2`-family vocab is built in the test: the 256 GPT-2 byte symbols, the
merges of a few rounds of BPE training on a small mixed corpus (ASCII words,
accented and CJK text, digits, whitespace runs), and two control tokens.
Both packages' Vocab.from_metadata read the same metadata, and their
tokenizers must give the same ids under the `gpt-2` and the `llama-bpe`
pre-tokenizers, with and without parse_special. The port's loader builds
the tokenizer from a GGUF; without the `regex` package it raises
NotImplementedError naming it, and the loader loads the model without one.
"""

import collections
import sys

import pytest
import torch

from llamacog_tpu.tokenizer import BpeTokenizer as JaxBpe
from llamacog_tpu.tokenizer import Vocab as JaxVocab
from llamacog_tpu.tokenizer.vocab import byte_encode
from llamacog_tpu.utils.testing import make_tiny_llama_gguf
from llamacog_tpu_torch.models.loader import load_model
from llamacog_tpu_torch.tokenizer import BpeTokenizer, Vocab, build_tokenizer

CORPUS = ("the quick brown fox jumps over the lazy dog. The dogs don't mind; they're "
          "lazy!! 12345 + 678 = 13023\n\n  indented   spaces\ttab\r\n"
          "café naïve über straße — «quotes» 東京都 日本語のテキスト 안녕하세요 "
          "привет мир αβγ ∑∫ emoji 🙂🙂 done.")
TEXTS = ["hello world", "The quick brown fox jumps over the lazy dog.",
         "don't stop, they've said; I'm here 'til 10:45", "café naïve über straße",
         "東京都 日本語のテキスト", "привет мир", "numbers 1234567890 and 3.14159",
         "  leading   and trailing  ", "tabs\tand\nnewlines\r\n\n\nend", "🙂 emoji 🙂🙂",
         "<|begin_of_text|>hello<|eot_id|> world", "x<|eot_id|><|eot_id|>y", ""]
SPECIALS = ["<|begin_of_text|>", "<|eot_id|>"]


def _train_merges(text: str, n_merges: int) -> list[str]:
    """Greedy BPE training on the byte-encoded words of `text`."""
    words = collections.Counter(byte_encode(w.encode()) for w in text.split(" ") if w)
    seqs = {w: list(w) for w in words}
    merges = []
    for _ in range(n_merges):
        pairs = collections.Counter()
        for w, seq in seqs.items():
            for a, b in zip(seq, seq[1:]):
                pairs[(a, b)] += words[w]
        if not pairs:
            break
        (a, b), _ = max(pairs.items(), key=lambda kv: (kv[1], kv[0]))
        merges.append(f"{a} {b}")
        for w, seq in seqs.items():
            out, i = [], 0
            while i < len(seq):
                if i + 1 < len(seq) and seq[i] == a and seq[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(seq[i])
                    i += 1
            seqs[w] = out
    return merges


def _metadata(pre: str) -> dict:
    merges = _train_merges(CORPUS * 3, 120)
    tokens = [byte_encode(bytes([b])) for b in range(256)]
    tokens += [m.replace(" ", "") for m in merges if m.replace(" ", "") not in tokens]
    tokens += SPECIALS
    types = [1] * (len(tokens) - len(SPECIALS)) + [3] * len(SPECIALS)
    return {"tokenizer.ggml.model": "gpt2", "tokenizer.ggml.pre": pre,
            "tokenizer.ggml.tokens": tokens, "tokenizer.ggml.token_type": types,
            "tokenizer.ggml.merges": merges,
            "tokenizer.ggml.bos_token_id": tokens.index(SPECIALS[0]),
            "tokenizer.ggml.eos_token_id": tokens.index(SPECIALS[1])}


def _gguf(tmp_path, md) -> str:
    return make_tiny_llama_gguf(str(tmp_path / "bpe.gguf"),
                                n_vocab=len(md["tokenizer.ggml.tokens"]), extra_metadata=md)


@pytest.mark.parametrize("pre", ["gpt-2", "llama-bpe"])
@pytest.mark.parametrize("parse_special", [False, True])
def test_bpe_ids_equal_the_jax_tokenizers(pre, parse_special):
    md = _metadata(pre)
    port, ref = BpeTokenizer(Vocab.from_metadata(md)), JaxBpe(JaxVocab.from_metadata(md))
    assert len(md["tokenizer.ggml.merges"]) > 100
    for text in TEXTS:
        for add_special in (False, True):
            want = ref.tokenize(text, add_special=add_special, parse_special=parse_special)
            got = port.tokenize(text, add_special=add_special, parse_special=parse_special)
            assert got == want, (pre, text)
    # the merges do merge: a common word is fewer tokens than its bytes
    assert len(port.tokenize("the lazy dog", add_special=False)) < len("the lazy dog")
    if parse_special:
        ids = port.tokenize("a<|eot_id|>b", add_special=False, parse_special=True)
        assert md["tokenizer.ggml.tokens"].index("<|eot_id|>") in ids


def test_load_model_builds_the_bpe_tokenizer(tmp_path):
    md = _metadata("llama-bpe")
    path = _gguf(tmp_path, md)
    model = load_model(path, dtype=torch.float32, device="cpu")
    assert isinstance(model.tokenizer, BpeTokenizer)
    ref = JaxBpe(JaxVocab.from_metadata(md))
    text = "The quick brown fox 123 <|eot_id|>"
    assert model.tokenizer.tokenize(text, parse_special=True) == ref.tokenize(
        text, parse_special=True)


def test_missing_regex_raises_by_name(tmp_path, monkeypatch):
    md = _metadata("gpt-2")
    monkeypatch.setitem(sys.modules, "regex", None)  # `import regex` raises ImportError
    with pytest.raises(NotImplementedError, match="`regex`"):
        build_tokenizer(Vocab.from_metadata(md))
    path = _gguf(tmp_path, md)
    model = load_model(path, dtype=torch.float32, device="cpu")
    assert model.tokenizer is None and model.vocab.model == "gpt2"
