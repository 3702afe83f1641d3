"""Byte-level BPE tokenizer with per-model pretokenizer regex presets.

Matches the reference (llama.cpp src/llama-vocab.cpp:278-620
llm_tokenizer_bpe): regexes are applied sequentially, carving text into words;
each word is GPT-2 byte-encoded; merges are applied lowest-rank-first with
left-position tie-breaking. Uses the `regex` package for \\p{..} classes and
lookaheads (the reference implements these with custom C++ matchers).

The port's own copy of llamacog_tpu/tokenizer/bpe.py. `regex` is imported
where a tokenizer is built, not with this module: a host without it loads
every other module of the port, and building a BPE tokenizer there raises
NotImplementedError naming `regex` (the loader then loads the model
without a tokenizer).
"""

from __future__ import annotations

import heapq

from .vocab import Vocab, byte_encode

# pretokenizer presets; names mirror tokenizer.ggml.pre values
# (regex strings per llama-vocab.cpp:281-470)
_LLAMA3 = r"(?:'[sS]|'[tT]|'[rR][eE]|'[vV][eE]|'[mM]|'[lL][lL]|'[dD])|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
_GPT2 = r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)"

PRE_REGEXES: dict[str, list[str]] = {
    "default": [
        r"[\p{P}\$\+<=>\^~\|]+",
        _GPT2,
        r"\p{N}+",
        r"[0-9][0-9][0-9]",
    ],
    "llama3": [_LLAMA3],
    "dbrx": [_LLAMA3],
    "smaug": [_LLAMA3],
    "deepseek-llm": [
        "[\r\n]",
        "\\s?[A-Za-z\u00b5\u00c0-\u00d6\u00d8-\u00f6\u00f8-\u01ba\u01bc-\u01bf\u01c4-\u0293\u0295-\u02af\u0370-\u0373\u0376\u0377\u037b-\u037d\u037f\u0386\u0388-\u038a\u038c\u038e-\u03a1\u03a3-\u03f5\u03f7-\u0481\u048a-\u052f\u0531-\u0556\u10a0-\u10c5\u13a0-\u13f5\u13f8-\u13fd\u1c90-\u1cba\u1cbd-\u1cbf\u1d00-\u1d2b\u1d6b-\u1d77\u1d79-\u1d9a\u1e00-\u1f15\u1f18-\u1f1d\u1f20-\u1f45\u1f48-\u1f4d\u1f50-\u1f57\u1f59\u1f5b\u1f5d\u1f5f-\u1f7d\u1f80-\u1fb4\u1fb6-\u1fbc\u1fbe\u1fc2-\u1fc4\u1fc6-\u1fcc\u1fd0-\u1fd3\u1fd6-\u1fdb\u1fe0-\u1fec\u1ff2-\u1ff4\u1ff6-\u1ffc\u2102\u2107\u210a-\u2113\u2115\u2119-\u211d\u2124\u2126\u2128\u212a-\u212d\u212f-\u2134\u2139\u213c-\u213f\u2145-\u2149\u214e\u2183\u2184\u2c00-\u2c7b\u2c7e-\u2ce4\u2ceb-\u2cee\u2cf2\u2cf3\ua640-\ua66d\ua680-\ua69b\ua722-\ua76f\ua771-\ua787\ua78b-\ua78e\uab70-\uabbf\ufb00-\ufb06\ufb13-\ufb17\uff21-\uff3a\uff41-\uff5a\U00010400-\U0001044f\U000104b0-\U000104d3\U000104d8-\U000104fb\U00010c80-\U00010cb2\U00010cc0-\U00010cf2\U000118a0-\U000118df\U0001e900-\U0001e943]+",
        "\\s?[!-/:-~\uff01-\uff0f\uff1a-\uff5e\u2018-\u201f\u3000-\u3002]+",
        "\\s+$",
        "[\u4e00-\u9fa5\u0800-\u4e00\uac00-\ud7ff]+",
        "\\p{N}+",
    ],
    "deepseek-coder": [
        "[\r\n]",
        "\\s?\\p{L}+",
        "\\s?\\p{P}+",
        "[\u4e00-\u9fa5\u0800-\u4e00\uac00-\ud7ff]+",
        "\\p{N}",
    ],
    "deepseek-v3": [
        "\\p{N}{1,3}",
        "[\u4e00-\u9fa5\u3040-\u309f\u30a0-\u30ff]+",
        "[!\"#$%&'()*+,\\-./:;<=>?@\\[\\\\\\]^_`{|}~][A-Za-z]+|[^\r\n\\p{L}\\p{P}\\p{S}]?[\\p{L}\\p{M}]+| ?[\\p{P}\\p{S}]+[\r\n]*|\\s*[\r\n]+|\\s+(?!\\S)|\\s+",
    ],
    "falcon": [
        r"[\p{P}\$\+<=>\^~\|`]+",
        _GPT2,
        r"[0-9][0-9][0-9]",
    ],
    "starcoder": [r"\p{N}", _GPT2],
    "gpt-2": [_GPT2],
    "mpt": [_GPT2],
    "qwen2": [
        r"(?:'[sS]|'[tT]|'[rR][eE]|'[vV][eE]|'[mM]|'[lL][lL]|'[dD])|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
    ],
    "poro-chat": [r" ?[^(\s|.,!?…。，、।۔،)]+"],
    "chatglm4": [_LLAMA3],
    "viking": [r" ?[^(\s|.,!?…。，、।۔،)]+", r"\p{N}"],
    "tekken": [
        r"[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]*[\p{Ll}\p{Lm}\p{Lo}\p{M}]+|[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]+[\p{Ll}\p{Lm}\p{Lo}\p{M}]*|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n/]*|\s*[\r\n]+|\s+(?!\S)|\s+"
    ],
    "gpt-4o": [
        r"[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]*[\p{Ll}\p{Lm}\p{Lo}\p{M}]+(?i:'s|'t|'re|'ve|'m|'ll|'d)?|[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]+[\p{Ll}\p{Lm}\p{Lo}\p{M}]*(?i:'s|'t|'re|'ve|'m|'ll|'d)?|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n/]*|\s*[\r\n]+|\s+(?!\S)|\s+"
    ],
    "superbpe": [r"\p{N}+", r"(?=(\d{3})+(?!\d))"],
    "bailingmoe": [
        r"'(?:[sSdDmMtT]|[lL][lL]|[vV][eE]|[rR][eE])|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]|\s+(?!\S)|\s+"
    ],
    "seed-coder": [
        r"(?:'[sS]|'[tT]|'[rR][eE]|'[vV][eE]|'[mM]|'[lL][lL]|'[dD])|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1}| ?[^\s\p{L}\p{N}\r\n]+|\s*[\r\n]+|\s+(?!\S)|\s+"
    ],
}

# pre-name aliases (llama-vocab.cpp:1518-1660)
_ALIASES = {
    "llama-v3": "llama3",
    "llama-bpe": "llama3",
    "falcon3": "llama3",
    "pixtral": "llama3",
    "smaug-bpe": "smaug",
    "deepseek-r1-qwen": "qwen2",
    "phi-2": "gpt-2",
    "jina-es": "gpt-2",
    "jina-de": "gpt-2",
    "gigachat": "gpt-2",
    "jina-v2-es": "gpt-2",
    "jina-v2-de": "gpt-2",
    "olmo": "gpt-2",
    "jais": "gpt-2",
    "trillion": "gpt-2",
    "refact": "starcoder",
    "command-r": "starcoder",
    "smollm": "starcoder",
    "codeshell": "starcoder",
    "exaone": "starcoder",
    "minerva-7b": "starcoder",
    "megrez": "gpt-2",
    "stablelm2": "qwen2",
    "glm4": "chatglm4",
    "chatglm-bpe": "chatglm4",
    "bloom": "poro-chat",
    "gpt3-finnish": "poro-chat",
    "llama4": "gpt-4o",
}


def get_regexes(pre: str) -> list[str]:
    pre = _ALIASES.get(pre, pre)
    return PRE_REGEXES.get(pre, PRE_REGEXES["default"])


class BpeTokenizer:
    def __init__(self, vocab: Vocab):
        try:
            import regex
        except ImportError as e:
            raise NotImplementedError(
                "the BPE tokenizer needs the `regex` package, which is not installed") from e
        self.vocab = vocab
        self.patterns = [regex.compile(rx) for rx in get_regexes(vocab.pre)]

    def _pretokenize(self, text: str) -> list[str]:
        segments = [text]
        for pat in self.patterns:
            out: list[str] = []
            for seg in segments:
                pos = 0
                for m in pat.finditer(seg):
                    if m.start() > pos:
                        out.append(seg[pos : m.start()])
                    if m.end() > m.start():
                        out.append(m.group())
                        pos = m.end()
                if pos < len(seg):
                    out.append(seg[pos:])
            segments = out
        return [byte_encode(w.encode("utf-8")) for w in segments]

    def _bpe_word(self, word: str, output: list[int]) -> None:
        v = self.vocab
        if v.ignore_merges and v.text_to_token(word) >= 0:
            output.append(v.text_to_token(word))
            return
        symbols = list(word)  # unicode chars of encoded word
        n = len(symbols)
        sizes = [1] * n  # in symbol counts
        texts = symbols[:]
        prevs = list(range(-1, n - 1))
        nexts = list(range(1, n)) + [-1]
        heap: list[tuple[int, int, str]] = []  # (rank, left, merged_text)

        def add_bigram(left: int, right: int) -> None:
            if left == -1 or right == -1:
                return
            pair = (texts[left], texts[right])
            rank = v.merge_ranks.get(pair)
            if rank is None:
                return
            heapq.heappush(heap, (rank, left, pair[0] + pair[1]))

        for i in range(1, n):
            add_bigram(i - 1, i)

        while heap:
            rank, left, merged = heapq.heappop(heap)
            if sizes[left] == 0:
                continue
            right = nexts[left]
            if right == -1 or sizes[right] == 0:
                continue
            if texts[left] + texts[right] != merged:
                continue
            texts[left] = merged
            sizes[left] += sizes[right]
            sizes[right] = 0
            nexts[left] = nexts[right]
            if nexts[right] >= 0:
                prevs[nexts[right]] = left
            add_bigram(prevs[left], left)
            add_bigram(left, nexts[left])

        i = 0
        while i != -1:
            if sizes[i] > 0:
                tok = v.text_to_token(texts[i])
                if tok >= 0:
                    output.append(tok)
                else:
                    for ch in texts[i]:
                        t = v.text_to_token(ch)
                        if t >= 0:
                            output.append(t)
            i = nexts[i]

    def tokenize(
        self, text: str, add_special: bool = True, parse_special: bool = False
    ) -> list[int]:
        v = self.vocab
        output: list[int] = []
        if add_special and v.add_bos and v.bos_id >= 0:
            output.append(v.bos_id)
        for frag in v.partition_specials(text, parse_special):
            if isinstance(frag, int):
                output.append(frag)
            else:
                for word in self._pretokenize(frag):
                    self._bpe_word(word, output)
        if add_special and v.add_eos and v.eos_id >= 0:
            output.append(v.eos_id)
        return output
