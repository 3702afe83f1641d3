"""The port's sampler chain (llamacog_tpu_torch/runtime/sampler.py) against
the JAX package's (llamacog_tpu/runtime/sampler.py): the same seeded numpy
logits, the same SamplerParams and the same seed give identical token
sequences over 64 sample/accept steps, for every kind of chain."""

from dataclasses import asdict

import numpy as np
import pytest

from llamacog_tpu.runtime import sampler as jax_sampler
from llamacog_tpu_torch.runtime import sampler

N_VOCAB = 48
N_STEPS = 64

CHAINS = {
    "greedy": dict(temp=0.0),
    "temp top-k top-p min-p": dict(temp=0.8, top_k=40, top_p=0.95, min_p=0.05, seed=7),
    "tight top-k top-p min-p": dict(temp=1.3, top_k=5, top_p=0.7, min_p=0.2, seed=8),
    "repetition penalties": dict(temp=0.7, penalty_last_n=16, penalty_repeat=1.3,
                                 penalty_freq=0.4, penalty_present=0.6, seed=11),
    "mirostat 1": dict(temp=1.0, mirostat=1, mirostat_tau=4.0, mirostat_eta=0.2, seed=3),
    "mirostat 2": dict(temp=1.0, mirostat=2, mirostat_tau=3.0, seed=5),
    "dry, token breakers": dict(temp=0.9, dry_multiplier=0.8, dry_allowed_length=2,
                                dry_sequence_breakers=(3, 7), seed=13),
    "logit bias": dict(temp=0.8, logit_bias={5: 4.0, 9: -100.0, 11: 2.5}, seed=17),
    "typical, xtc": dict(temp=0.9, typ_p=0.9, xtc_probability=0.5, xtc_threshold=0.05,
                         seed=19),
    "top-n-sigma, dynatemp": dict(temp=0.8, top_n_sigma=1.5, dynatemp_range=0.4, seed=23),
}


def _logits(seed: int) -> np.ndarray:
    """[N_STEPS, N_VOCAB] f32 logits that favour a short cycle of tokens, so
    the repetition penalties and DRY have repeats to act on."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((N_STEPS, N_VOCAB)).astype(np.float32) * 2.0
    logits[np.arange(N_STEPS), np.arange(N_STEPS) % 5] += 3.0
    return logits


def _draw(module, params: dict, logits: np.ndarray, tokenizer=None) -> list[int]:
    chain = module.SamplerChain(module.SamplerParams(**params), n_vocab=N_VOCAB,
                                tokenizer=tokenizer)
    out = []
    for row in logits:
        tok = chain.sample(row)
        chain.accept(tok)
        out.append(tok)
    return out


@pytest.mark.parametrize("name", list(CHAINS))
def test_sampler_chain_draws_the_jax_chains_tokens(name):
    params = CHAINS[name]
    logits = _logits(1234)
    want = _draw(jax_sampler, params, logits)
    got = _draw(sampler, params, logits)
    assert got == want
    if params["temp"] > 0:
        assert len(set(got)) > 3  # a sampled run, not a constant


class _Breakers:
    """A tokenizer stand-in for the DRY breaker strings: each string maps to
    a fixed token id."""

    IDS = {"\n": [1], ":": [2], '"': [4], "*": [6]}

    def tokenize(self, text, add_special=False):
        return self.IDS[text]


def test_dry_breaker_strings_through_a_tokenizer():
    """The chain takes the tokenizer argument as the JAX copy does and
    adds the tokenized breaker strings to the restart set."""
    params = dict(temp=0.9, dry_multiplier=1.2, dry_allowed_length=1, seed=29)
    logits = _logits(99)
    chain = sampler.SamplerChain(sampler.SamplerParams(**params), n_vocab=N_VOCAB,
                                 tokenizer=_Breakers())
    assert chain.dry_breakers == {1, 2, 4, 6}
    assert (_draw(sampler, params, logits, _Breakers())
            == _draw(jax_sampler, params, logits, _Breakers()))


def test_sampler_params_defaults_match_jax():
    assert asdict(sampler.SamplerParams()) == asdict(jax_sampler.SamplerParams())
