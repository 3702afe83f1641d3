"""Vocabulary built from GGUF metadata, with special-token handling and
detokenization.

Semantics follow the reference tokenizer layer (llama.cpp src/llama-vocab.cpp):
token attributes (llama.h:141-151), special-token partition
(llama-vocab.cpp:2237), SPM whitespace escaping (:2372), and GPT-2 byte-level
text decode (:2380).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any

import numpy as np


class TokenAttr(enum.IntFlag):
    UNDEFINED = 0
    UNKNOWN = 1 << 0
    UNUSED = 1 << 1
    NORMAL = 1 << 2
    CONTROL = 1 << 3
    USER_DEFINED = 1 << 4
    BYTE = 1 << 5
    NORMALIZED = 1 << 6
    LSTRIP = 1 << 7
    RSTRIP = 1 << 8
    SINGLE_WORD = 1 << 9


# gguf token_type (llama_token_type) -> attr
_TOKEN_TYPE_TO_ATTR = {
    0: TokenAttr.UNDEFINED,
    1: TokenAttr.NORMAL,
    2: TokenAttr.UNKNOWN,
    3: TokenAttr.CONTROL,
    4: TokenAttr.USER_DEFINED,
    5: TokenAttr.UNUSED,
    6: TokenAttr.BYTE,
}

SPM_SPACE = "▁"  # ▁


def gpt2_byte_to_unicode() -> dict[int, str]:
    """The GPT-2 byte→unicode-char mapping (bijective over 0..255)."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


BYTE_TO_UNICODE = gpt2_byte_to_unicode()
UNICODE_TO_BYTE = {v: k for k, v in BYTE_TO_UNICODE.items()}


def byte_encode(text_bytes: bytes) -> str:
    return "".join(BYTE_TO_UNICODE[b] for b in text_bytes)


def byte_decode(text: str) -> bytes:
    out = bytearray()
    for ch in text:
        b = UNICODE_TO_BYTE.get(ch)
        if b is None:
            # reference emits an [UNK_BYTE_..] marker; we pass the char through
            out.extend(ch.encode("utf-8"))
        else:
            out.append(b)
    return bytes(out)


@dataclass
class Vocab:
    tokens: list[str]
    scores: np.ndarray | None
    attrs: list[TokenAttr]
    model: str  # "llama" (SPM) | "gpt2" (BPE) | "bert" (WPM) | "t5" (UGM) | "rwkv" | "none"
    pre: str = "default"
    merges: list[str] = field(default_factory=list)
    bos_id: int = -1
    eos_id: int = -1
    unk_id: int = -1
    sep_id: int = -1
    pad_id: int = -1
    eot_id: int = -1
    eom_id: int = -1
    fim_pre_id: int = -1
    fim_suf_id: int = -1
    fim_mid_id: int = -1
    fim_pad_id: int = -1
    fim_rep_id: int = -1
    fim_sep_id: int = -1
    add_bos: bool = False
    add_eos: bool = False
    add_space_prefix: bool = True
    ignore_merges: bool = False
    remove_extra_whitespaces: bool = False
    chat_template: str | None = None

    def __post_init__(self):
        self.token_to_id: dict[str, int] = {}
        self.token_bytes_to_id: dict[bytes, int] = {}
        for i, t in enumerate(self.tokens):
            self.token_to_id.setdefault(t, i)
            self.token_bytes_to_id.setdefault(t.encode("utf-8"), i)
        self.merge_ranks: dict[tuple[str, str], int] = {}
        for rank, m in enumerate(self.merges):
            # merges stored as "left right" (space-separated); the reference
            # splits on the *first and only* space between the two parts
            parts = m.split(" ")
            if len(parts) == 2:
                self.merge_ranks[(parts[0], parts[1])] = rank
        # special-token cache: CONTROL|USER_DEFINED|UNKNOWN, longest text first
        # (llama-vocab.cpp:2035-2046)
        special = TokenAttr.CONTROL | TokenAttr.USER_DEFINED | TokenAttr.UNKNOWN
        self.special_tokens = sorted(
            (i for i, a in enumerate(self.attrs) if a & special),
            key=lambda i: -len(self.tokens[i]),
        )
        self.eog_ids = {t for t in (self.eos_id, self.eot_id, self.eom_id) if t >= 0}

    # -- construction -------------------------------------------------------
    @classmethod
    def from_metadata(cls, md: dict[str, Any]) -> "Vocab":
        tokens = list(md["tokenizer.ggml.tokens"])
        n = len(tokens)
        scores = md.get("tokenizer.ggml.scores")
        if scores is not None:
            scores = np.asarray(scores, dtype=np.float32)
        ttypes = md.get("tokenizer.ggml.token_type")
        if ttypes is not None:
            attrs = [_TOKEN_TYPE_TO_ATTR.get(int(t), TokenAttr.UNDEFINED) for t in ttypes]
        else:
            attrs = [TokenAttr.NORMAL] * n
        model = str(md.get("tokenizer.ggml.model", "llama"))
        is_spm = model == "llama"

        def tid(key, default=-1):
            v = md.get(f"tokenizer.ggml.{key}")
            return int(v) if v is not None else default

        v = cls(
            tokens=tokens,
            scores=scores,
            attrs=attrs,
            model=model,
            pre=str(md.get("tokenizer.ggml.pre", "default")),
            merges=list(md.get("tokenizer.ggml.merges", [])),
            bos_id=tid("bos_token_id", 1 if is_spm else -1),
            eos_id=tid("eos_token_id", 2 if is_spm else -1),
            unk_id=tid("unknown_token_id", 0 if is_spm else -1),
            sep_id=tid("seperator_token_id"),
            pad_id=tid("padding_token_id"),
            eot_id=tid("eot_token_id"),
            eom_id=tid("eom_token_id"),
            fim_pre_id=tid("fim_pre_token_id"),
            fim_suf_id=tid("fim_suf_token_id"),
            fim_mid_id=tid("fim_mid_token_id"),
            fim_pad_id=tid("fim_pad_token_id"),
            fim_rep_id=tid("fim_rep_token_id"),
            fim_sep_id=tid("fim_sep_token_id"),
            add_bos=bool(md.get("tokenizer.ggml.add_bos_token", is_spm)),
            add_eos=bool(md.get("tokenizer.ggml.add_eos_token", False)),
            add_space_prefix=bool(md.get("tokenizer.ggml.add_space_prefix", is_spm)),
            ignore_merges=bool(md.get("tokenizer.ggml.ignore_merges", False)),
            remove_extra_whitespaces=bool(
                md.get("tokenizer.ggml.remove_extra_whitespaces", False)
            ),
            chat_template=md.get("tokenizer.chat_template"),
        )
        return v

    # -- lookups ------------------------------------------------------------
    def n_tokens(self) -> int:
        return len(self.tokens)

    def text_to_token(self, text: str) -> int:
        return self.token_to_id.get(text, -1)

    def bytes_to_token(self, data: bytes) -> int:
        return self.token_bytes_to_id.get(data, -1)

    def byte_to_token(self, byte: int) -> int:
        if self.model == "llama":  # SPM
            tok = self.token_to_id.get(f"<0x{byte:02X}>")
            if tok is not None:
                return tok
            tok = self.token_to_id.get(chr(byte))
            if tok is not None:
                return tok
            return self.unk_id
        return self.token_to_id.get(BYTE_TO_UNICODE[byte], self.unk_id)

    def is_eog(self, token: int) -> bool:
        return token in self.eog_ids

    # -- special-token partition (llama-vocab.cpp:2237-2352) ----------------
    def partition_specials(self, text: str, parse_special: bool) -> list:
        """Split raw text into fragments: str pieces and int special-token ids."""
        fragments: list = [text] if text else []
        for sid in self.special_tokens:
            attr = self.attrs[sid]
            if not parse_special and attr & (TokenAttr.CONTROL | TokenAttr.UNKNOWN):
                continue
            stext = self.tokens[sid]
            if not stext:
                continue
            out: list = []
            for frag in fragments:
                if not isinstance(frag, str):
                    out.append(frag)
                    continue
                rest = frag
                while True:
                    pos = rest.find(stext)
                    if pos < 0:
                        if rest:
                            out.append(rest)
                        break
                    left = rest[:pos]
                    if attr & TokenAttr.LSTRIP:
                        left = left.rstrip()
                    if left:
                        out.append(left)
                    out.append(sid)
                    rest = rest[pos + len(stext):]
                    if attr & TokenAttr.RSTRIP:
                        rest = rest.lstrip()
            fragments = out
        return fragments

    # -- detokenization ------------------------------------------------------
    def token_to_piece(self, token: int, special: bool = False) -> bytes:
        """Raw bytes of one token (llama_vocab::token_to_piece semantics)."""
        if token < 0 or token >= len(self.tokens):
            return b""
        attr = self.attrs[token]
        text = self.tokens[token]
        if attr & (TokenAttr.CONTROL | TokenAttr.UNKNOWN) and not special:
            # control tokens render empty unless asked for
            if token not in (self.bos_id, self.eos_id) or not special:
                return b""
        if attr & TokenAttr.BYTE:
            if self.model == "llama" and text.startswith("<0x") and text.endswith(">"):
                try:
                    b = int(text[3:-1], 16)
                except ValueError:
                    b = -1
                if 0 <= b <= 255:
                    return bytes([b])
                return text.encode("utf-8")  # malformed byte token: literal
            return byte_decode(text)
        if self.model == "llama":  # SPM
            return text.replace(SPM_SPACE, " ").encode("utf-8")
        if self.model == "gpt2":  # byte-level BPE
            return byte_decode(text)
        if self.model == "bert":  # WPM
            return text.replace("##", "").replace(SPM_SPACE, " ").encode("utf-8")
        if self.model == "rwkv":  # escape-coded byte strings
            raise NotImplementedError("rwkv vocab is not ported yet")
        return text.encode("utf-8")

    def detokenize(
        self, tokens, remove_special: bool = False, unparse_special: bool = False
    ) -> str:
        tokens = list(tokens)
        if remove_special:
            if self.add_bos and tokens and tokens[0] == self.bos_id:
                tokens = tokens[1:]
            if self.add_eos and tokens and tokens[-1] == self.eos_id:
                tokens = tokens[:-1]
        out = b"".join(self.token_to_piece(t, special=unparse_special) for t in tokens)
        text = out.decode("utf-8", errors="replace")
        # SPM drops one leading space it inserted during tokenization
        if self.model == "llama" and self.add_space_prefix and text.startswith(" "):
            text = text[1:]
        return text
