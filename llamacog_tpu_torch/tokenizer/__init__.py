from .bpe import BpeTokenizer
from .spm import SpmTokenizer
from .vocab import TokenAttr, Vocab


def build_tokenizer(vocab: Vocab):
    """Tokenizer factory by vocab model family. The port carries the SPM
    ("llama") and the byte-level BPE ("gpt2") tokenizers; the other families
    are still to be ported. BPE needs the `regex` package and raises
    NotImplementedError naming it where it is missing."""
    if vocab.model == "llama":
        return SpmTokenizer(vocab)
    if vocab.model == "gpt2":
        return BpeTokenizer(vocab)
    if vocab.model in ("none", "no_vocab"):
        raise ValueError("model has no vocab")
    raise NotImplementedError(f"tokenizer model {vocab.model!r} is not ported yet")


__all__ = [
    "BpeTokenizer",
    "SpmTokenizer",
    "TokenAttr",
    "Vocab",
    "build_tokenizer",
]
