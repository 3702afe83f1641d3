"""Sampler chain (reference: src/llama-sampling.cpp, chain assembly
common/sampling.cpp:225-282).

The port's own copy of llamacog_tpu/runtime/sampler.py, numpy only:
host-side stateless transforms plus the stateful penalty samplers, in the
reference's default order: logit_bias → penalties → [dry] → top-k →
typical → top-p → min-p → xtc → temp/temp-ext → dist; mirostat replaces
the truncation stack; temp<=0 means greedy. With the same params, seed and
logits it draws the same tokens as the JAX package's chain.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np


@dataclass
class SamplerParams:
    temp: float = 0.8
    dynatemp_range: float = 0.0
    dynatemp_exponent: float = 1.0
    top_k: int = 40
    top_p: float = 0.95
    min_p: float = 0.05
    typ_p: float = 1.0
    xtc_probability: float = 0.0
    xtc_threshold: float = 0.1
    top_n_sigma: float = -1.0
    penalty_last_n: int = 64
    penalty_repeat: float = 1.0
    penalty_freq: float = 0.0
    penalty_present: float = 0.0
    mirostat: int = 0  # 0 off, 1, 2
    mirostat_tau: float = 5.0
    mirostat_eta: float = 0.1
    # DRY repetition penalty (llama_sampler_dry, llama-sampling.cpp:1892)
    dry_multiplier: float = 0.0  # 0 = disabled
    dry_base: float = 1.75
    dry_allowed_length: int = 2
    dry_penalty_last_n: int = -1  # -1 = whole window
    dry_sequence_breakers: tuple = ()  # token ids that reset repetition
    # breaker *strings* tokenized at chain construction (reference defaults
    # '\n', ':', '"', '*' — common/common.h default_sampling dry_sequence_breakers)
    dry_sequence_breaker_strings: tuple = ("\n", ":", '"', "*")
    seed: int = -1
    logit_bias: dict[int, float] = field(default_factory=dict)
    min_keep: int = 1


def _softmax(x: np.ndarray) -> np.ndarray:
    m = x.max()
    e = np.exp(x - m)
    return e / e.sum()


class SamplerChain:
    def __init__(self, params: SamplerParams, n_vocab: int, grammar=None,
                 tokenizer=None):
        self.p = params
        self.n_vocab = n_vocab
        self.grammar = grammar
        seed = params.seed if params.seed not in (-1, 0xFFFFFFFF) else None
        self.rng = np.random.default_rng(seed)
        self.prev: deque[int] = deque(maxlen=max(params.penalty_last_n, 1))
        self.mu = 2.0 * params.mirostat_tau  # mirostat state
        # DRY restart set: explicit token ids plus tokenized breaker strings
        # (server.cpp passes strings; llama_sampler_dry preprocesses them
        # against the vocab). Without a tokenizer only explicit ids apply.
        self.dry_breakers: set[int] = set(params.dry_sequence_breakers)
        if tokenizer is not None and params.dry_multiplier > 0.0:
            for s in params.dry_sequence_breaker_strings:
                try:
                    self.dry_breakers.update(
                        tokenizer.tokenize(s, add_special=False)
                    )
                except Exception:
                    pass

    # -- individual transforms (operate on a logits copy) -------------------
    def _apply_penalties(self, logits: np.ndarray) -> None:
        p = self.p
        if not self.prev or (
            p.penalty_repeat == 1.0 and p.penalty_freq == 0.0 and p.penalty_present == 0.0
        ):
            return
        counts: dict[int, int] = {}
        for t in self.prev:
            counts[t] = counts.get(t, 0) + 1
        for t, c in counts.items():
            l = logits[t]
            if p.penalty_repeat != 1.0:
                l = l / p.penalty_repeat if l > 0 else l * p.penalty_repeat
            l -= c * p.penalty_freq + (1.0 if c > 0 else 0.0) * p.penalty_present
            logits[t] = l

    def _apply_dry(self, logits: np.ndarray) -> None:
        """DRY repetition penalty: penalize tokens that would extend a
        repeated suffix of the context (llama-sampling.cpp:1892-2090,
        reverse Z-algorithm repeat counts)."""
        p = self.p
        if p.dry_multiplier <= 0.0 or p.dry_base < 1.0:
            return
        toks = list(self.prev)
        if p.dry_penalty_last_n > 0:
            toks = toks[-p.dry_penalty_last_n:]
        n = len(toks)
        if n <= p.dry_allowed_length:
            return
        # restart sequences bound the usable suffix length
        rep_limit = n
        for i, t in enumerate(reversed(toks)):
            if t in self.dry_breakers:
                rep_limit = i
                break
        if rep_limit < p.dry_allowed_length:
            return
        # reverse Z-array: z[j] = length of the match between the suffix
        # ending at position j and the whole-context suffix
        rev = toks[::-1]
        z = [0] * n
        lt = rt = 0
        for k in range(1, n):
            if k > rt:
                m = 0
                while k + m < n and rev[m] == rev[k + m]:
                    m += 1
                z[k] = m
                if m > 0:
                    lt, rt = k, k + m - 1
            else:
                pk = k - lt
                if z[pk] < rt - k + 1:
                    z[k] = z[pk]
                else:
                    i2 = rt + 1
                    while i2 < n and rev[i2] == rev[i2 - k]:
                        i2 += 1
                    z[k] = i2 - k
                    lt, rt = k, i2 - 1
        max_repeat: dict[int, int] = {}
        for k in range(1, n):
            rl = min(z[k], rep_limit)
            if rl >= p.dry_allowed_length:
                # the token right after this repeated run (nearer the end)
                nxt = rev[k - 1]
                if max_repeat.get(nxt, 0) < rl:
                    max_repeat[nxt] = rl
        if not max_repeat:
            return
        max_exp = 88.7228391 / np.log(p.dry_base) if p.dry_base > 1.000001 else 0
        for tok, rl in max_repeat.items():
            if tok in self.dry_breakers:
                continue
            e = rl - p.dry_allowed_length
            if max_exp > 0:
                e = min(e, max_exp)
            logits[tok] -= p.dry_multiplier * (p.dry_base**e)

    @staticmethod
    def top_k_mask(logits: np.ndarray, k: int) -> np.ndarray:
        if k <= 0 or k >= logits.size:
            return logits
        kth = np.partition(logits, -k)[-k]
        out = np.where(logits >= kth, logits, -np.inf)
        return out

    @staticmethod
    def top_p_mask(logits: np.ndarray, top_p: float, min_keep: int = 1) -> np.ndarray:
        if top_p >= 1.0:
            return logits
        order = np.argsort(-logits, kind="stable")
        probs = _softmax(logits[order])
        cum = np.cumsum(probs)
        # keep through the first token where cum >= p (llama-sampling.cpp top_p)
        cut = int(np.searchsorted(cum, top_p) + 1)
        cut = max(cut, min_keep)
        out = np.full_like(logits, -np.inf)
        keep = order[:cut]
        out[keep] = logits[keep]
        return out

    @staticmethod
    def min_p_mask(logits: np.ndarray, min_p: float, min_keep: int = 1) -> np.ndarray:
        if min_p <= 0.0:
            return logits
        mx = logits.max()
        # p_i >= min_p * p_max  <=>  logit_i >= logit_max + log(min_p)
        thresh = mx + np.log(min_p)
        out = np.where(logits >= thresh, logits, -np.inf)
        if np.isfinite(out).sum() < min_keep:
            order = np.argsort(-logits)[:min_keep]
            out = np.full_like(logits, -np.inf)
            out[order] = logits[order]
        return out

    @staticmethod
    def typical_mask(logits: np.ndarray, typ_p: float, min_keep: int = 1) -> np.ndarray:
        if typ_p >= 1.0:
            return logits
        probs = _softmax(logits)
        ent = -np.sum(probs * np.log(probs + 1e-20))
        shifted = np.abs(-np.log(probs + 1e-20) - ent)
        order = np.argsort(shifted, kind="stable")
        cum = np.cumsum(probs[order])
        cut = max(int(np.searchsorted(cum, typ_p) + 1), min_keep)
        out = np.full_like(logits, -np.inf)
        keep = order[:cut]
        out[keep] = logits[keep]
        return out

    def _xtc(self, logits: np.ndarray) -> np.ndarray:
        p = self.p
        if p.xtc_probability <= 0.0 or self.rng.random() > p.xtc_probability:
            return logits
        probs = _softmax(logits)
        above = np.where(probs >= p.xtc_threshold)[0]
        if above.size >= 2:
            # remove all but the *least* probable of the above-threshold tokens
            keep_out = above[np.argsort(-logits[above])][:-1]
            logits = logits.copy()
            logits[keep_out] = -np.inf
        return logits

    def _top_n_sigma(self, logits: np.ndarray) -> np.ndarray:
        n = self.p.top_n_sigma
        if n <= 0.0:
            return logits
        finite = logits[np.isfinite(logits)]
        mx, std = finite.max(), finite.std()
        return np.where(logits >= mx - n * std, logits, -np.inf)

    def _temp(self, logits: np.ndarray) -> np.ndarray:
        p = self.p
        if p.dynatemp_range > 0.0:
            # entropy-scaled dynamic temperature (llama-sampling.cpp temp_ext)
            mn = max(0.0, p.temp - p.dynatemp_range)
            mxt = p.temp + p.dynatemp_range
            probs = _softmax(logits)
            nz = probs[probs > 0]
            ent = -np.sum(nz * np.log(nz))
            max_ent = np.log(len(nz)) if len(nz) > 1 else 1.0
            norm = ent / max_ent if max_ent > 0 else 0.0
            dyn = mn + (mxt - mn) * (norm ** p.dynatemp_exponent)
            return logits / max(dyn, 1e-6)
        return logits / p.temp

    # -- public API ----------------------------------------------------------
    def is_pure_greedy(self) -> bool:
        """True when sample() reduces to bare argmax of the raw logits —
        the condition for on-device speculative decoding to be exact
        (runtime/speculative.OnDeviceSpeculative accepts by argmax match)."""
        p = self.p
        return (
            p.temp <= 0.0
            and self.grammar is None
            and not p.logit_bias
            and p.penalty_repeat == 1.0
            and p.penalty_freq == 0.0
            and p.penalty_present == 0.0
            and p.dry_multiplier == 0.0
            and p.mirostat == 0
        )

    def sample(self, logits: np.ndarray) -> int:
        p = self.p
        logits = np.asarray(logits, dtype=np.float32).copy()
        for t, b in p.logit_bias.items():
            logits[t] += b
        self._apply_penalties(logits)
        self._apply_dry(logits)
        base_logits = logits.copy()  # pre-truncation, for grammar fallback
        if p.temp <= 0.0:
            tok = int(np.argmax(logits))
        elif p.mirostat == 1:
            # mirostat v1 (llama_sampler_mirostat, llama-sampling.cpp):
            # estimate the Zipf exponent s_hat from the top-100 probability
            # ratios, derive k from the target surprise mu, then top-k sample
            logits = logits / p.temp
            probs = _softmax(logits)
            order = np.argsort(-probs, kind="stable")
            sp = probs[order]
            m = 100
            n_pairs = max(min(sp.size, m) - 1, 1)
            i = np.arange(n_pairs, dtype=np.float64)
            t_i = np.log((i + 2) / (i + 1))
            b_i = np.log(sp[:n_pairs] / np.maximum(sp[1 : n_pairs + 1], 1e-20))
            s_hat = float((t_i * b_i).sum() / max((t_i * t_i).sum(), 1e-20))
            eps_hat = s_hat - 1.0
            n = float(self.n_vocab)
            denom = 1.0 - n ** (-eps_hat) if abs(eps_hat) > 1e-9 else 1e-9
            k = (eps_hat * (2.0 ** self.mu) / denom) ** (1.0 / max(s_hat, 1e-9))
            k = int(np.clip(np.round(k), 1, sp.size))
            keep = order[:k]
            kp = probs[keep] / probs[keep].sum()
            idx = int(self.rng.choice(k, p=kp))
            tok = int(keep[idx])
            observed = -np.log2(kp[idx] + 1e-20)
            self.mu -= p.mirostat_eta * (observed - p.mirostat_tau)
        elif p.mirostat == 2:
            logits = logits / p.temp
            probs = _softmax(logits)
            order = np.argsort(-probs, kind="stable")
            # mirostat v2: truncate tokens with surprise > mu
            surprise = -np.log2(probs[order] + 1e-20)
            keep = order[surprise <= self.mu]
            if keep.size == 0:
                keep = order[:1]
            kp = probs[keep] / probs[keep].sum()
            tok = int(self.rng.choice(keep, p=kp))
            observed = -np.log2(probs[tok] + 1e-20)
            self.mu -= p.mirostat_eta * (observed - p.mirostat_tau)
        else:
            if p.top_n_sigma > 0.0:
                logits = self._temp(logits)
                logits = self._top_n_sigma(logits)
            else:
                logits = self.top_k_mask(logits, p.top_k)
                logits = self.typical_mask(logits, p.typ_p, p.min_keep)
                logits = self.top_p_mask(logits, p.top_p, p.min_keep)
                logits = self.min_p_mask(logits, p.min_p, p.min_keep)
                logits = self._xtc(logits)
                logits = self._temp(logits)
            probs = _softmax(logits)
            tok = int(self.rng.choice(self.n_vocab, p=probs))
        if self.grammar is not None:
            # lazy-grammar trick (common/sampling.h:20-25): check only the
            # sampled token; on violation mask and resample once
            if not self.grammar.accepts_token(tok):
                mask = self.grammar.token_mask()
                logits2 = np.where(mask, logits, -np.inf)
                if not np.isfinite(logits2).any():
                    # truncation (top-k/p) removed every grammar-legal token:
                    # fall back to masking the untruncated logits
                    logits2 = np.where(mask, base_logits, -np.inf)
                if np.isfinite(logits2).any():
                    probs = _softmax(logits2)
                    tok = int(self.rng.choice(self.n_vocab, p=probs))
        return tok

    def accept(self, token: int) -> None:
        self.prev.append(token)
        if self.grammar is not None:
            self.grammar.accept_token(token)
