"""N-gram cache for lookup decoding (reference: common/ngram-cache.{h,cpp},
examples/lookup): map recent n-grams to observed continuation counts, draft
continuations without a model, and let the target verify them in one step.

The port's own copy of llamacog_tpu/runtime/ngram_cache.py (it imports no JAX);
its pickled files load in either package.
"""

from __future__ import annotations

import pickle
from collections import defaultdict

NGRAM_MIN = 1
NGRAM_MAX = 4


class NgramCache:
    def __init__(self):
        # ngram tuple -> {token: count}
        self.parts: dict[tuple, dict[int, int]] = defaultdict(dict)

    def update(self, tokens: list[int], ngram_min: int = NGRAM_MIN, ngram_max: int = NGRAM_MAX):
        for n in range(ngram_min, ngram_max + 1):
            for i in range(len(tokens) - n):
                key = tuple(tokens[i : i + n])
                nxt = tokens[i + n]
                d = self.parts[key]
                d[nxt] = d.get(nxt, 0) + 1

    def _best(self, key: tuple) -> tuple[int, int, int]:
        """(token, count, total) for the most frequent continuation."""
        d = self.parts.get(key)
        if not d:
            return -1, 0, 0
        tok = max(d, key=d.get)
        return tok, d[tok], sum(d.values())

    def draft(self, tokens: list[int], n_draft: int = 8, min_hits: int = 1,
              min_frac: float = 0.5) -> list[int]:
        out: list[int] = []
        ctx = list(tokens)
        for _ in range(n_draft):
            best_tok = -1
            for n in range(NGRAM_MAX, NGRAM_MIN - 1, -1):
                if len(ctx) < n:
                    continue
                tok, cnt, total = self._best(tuple(ctx[-n:]))
                if tok >= 0 and cnt >= min_hits and cnt / max(total, 1) >= min_frac:
                    best_tok = tok
                    break
            if best_tok < 0:
                break
            out.append(best_tok)
            ctx.append(best_tok)
        return out

    def save(self, path: str):
        with open(path, "wb") as f:
            pickle.dump(dict(self.parts), f)

    @classmethod
    def load(cls, path: str) -> "NgramCache":
        c = cls()
        with open(path, "rb") as f:
            c.parts.update(pickle.load(f))
        return c

    def merge(self, other: "NgramCache"):
        for key, d in other.parts.items():
            mine = self.parts[key]
            for tok, cnt in d.items():
                mine[tok] = mine.get(tok, 0) + cnt
