from .spm import SpmTokenizer
from .vocab import TokenAttr, Vocab


def build_tokenizer(vocab: Vocab):
    """Tokenizer factory by vocab model family. The port carries the SPM
    ("llama") tokenizer only; the other families are still to be ported."""
    if vocab.model == "llama":
        return SpmTokenizer(vocab)
    if vocab.model in ("none", "no_vocab"):
        raise ValueError("model has no vocab")
    raise NotImplementedError(f"tokenizer model {vocab.model!r} is not ported yet")


__all__ = [
    "SpmTokenizer",
    "TokenAttr",
    "Vocab",
    "build_tokenizer",
]
