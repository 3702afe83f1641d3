"""The port's speculative decoding (llamacog_tpu_torch/runtime/speculative.py),
Engine.prefill_logits and the n-gram cache copy, held against the JAX
package on the CPU.

Both packages load the tiny 4-layer Q4_0 GGUF of tests/test_spec_ondevice.py
(make_tiny_llama_gguf: n_embd 64, the port's wire format takes its 32-weight
rows) in f32, the JAX side through its Pallas kernels in interpret mode.
Tokens, accept statistics and row lengths must be equal; logits agree
within the model tests' f32 tolerance (atol 2e-3, rtol 1e-3: both sides
multiply f32 operands and differ in summation order only). The JAX
on-device loop compiles one jitted while_loop per instance (why
tests/test_spec_ondevice.py is marked slow): this module builds two, at one
(n, k), and holds the port's other cases against the port's own greedy
loop (Engine.decode_greedy_tokens, which tests/test_torch_engine_graph.py
holds against the JAX engine).
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from llamacog_tpu_torch.models.loader import load_model
from llamacog_tpu_torch.runtime.engine import Engine
from llamacog_tpu_torch.runtime.ngram_cache import NgramCache
from llamacog_tpu_torch.runtime.sampler import SamplerChain, SamplerParams
from llamacog_tpu_torch.runtime.speculative import (OnDeviceSpeculative, SpeculativeDecoder,
                                                    SpeculativeParams, truncated_draft_params)

PROMPT = list(range(2, 18))
PROMPT2 = [7, 40, 99, 3, 250, 61, 12]
MAX_SEQ = 128
N_SPEC = 24
LOGITS_TOL = dict(atol=2e-3, rtol=1e-3)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's torch ops on one thread (its model is 64 wide; under the
    test runner's parallel workers more threads contend for the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    import jax.numpy as jnp

    from llamacog_tpu.gguf import GGMLType
    from llamacog_tpu.models.loader import load_model as jax_load_model
    from llamacog_tpu.utils.testing import make_tiny_llama_gguf

    path = str(tmp_path_factory.mktemp("spec") / "tiny.gguf")
    make_tiny_llama_gguf(path, quant_type=GGMLType.Q4_0, n_layer=4)
    return {"jax": jax_load_model(path, mode="quantized", dtype=jnp.float32),
            "port": load_model(path, dtype=torch.float32, device="cpu")}


def _side(models, side):
    """(model, Engine class, engine kwargs, speculative module) of a side."""
    if side == "jax":
        import jax.numpy as jnp

        from llamacog_tpu.runtime import speculative
        from llamacog_tpu.runtime.engine import Engine as JaxEngine

        return models["jax"], JaxEngine, dict(dtype=jnp.float32), speculative
    from llamacog_tpu_torch.runtime import speculative

    return models["port"], Engine, dict(dtype=torch.float32, device="cpu"), speculative


def _pair(models, side, n_draft_layers=None, batch_size=1):
    """Target and draft engines of a side; the draft is the target's weights,
    or its first n_draft_layers."""
    m, E, kw, mod = _side(models, side)
    t = E(m.params, m.config, batch_size=batch_size, max_seq=MAX_SEQ, **kw)
    if n_draft_layers is None:
        dp, dc = m.params, m.config
    else:
        dp = mod.truncated_draft_params(m.params, n_draft_layers)
        dc = replace(m.config, n_layer=n_draft_layers)
    return t, E(dp, dc, batch_size=batch_size, max_seq=MAX_SEQ, **kw), mod


@pytest.mark.parametrize("batch_size,row", [(1, 0), (2, 1)])
def test_prefill_logits_match_jax(models, batch_size, row):
    """Every position's logits [n, V] of a row's prefill, at B = 1 and on row
    1 of B = 2 (row 0 prefilled first: the row view's cache), and the rows'
    lengths advanced by n."""
    got = {}
    for side in ("jax", "port"):
        m, E, kw, _ = _side(models, side)
        eng = E(m.params, m.config, batch_size=batch_size, max_seq=MAX_SEQ, **kw)
        if row:
            eng.prefill(PROMPT2, row=0)
        first = np.asarray(eng.prefill_logits(PROMPT[:5], row=row))
        second = np.asarray(eng.prefill_logits(PROMPT[5:], row=row))
        got[side] = (first, second, np.asarray(eng.seq_len).copy())
    for a, b in zip(got["port"][:2], got["jax"][:2]):
        assert a.shape == b.shape and a.dtype == np.float32
        np.testing.assert_allclose(a, b, **LOGITS_TOL)
    assert got["port"][0].shape == (5, models["port"].config.n_vocab)
    np.testing.assert_array_equal(got["port"][2], got["jax"][2])
    assert int(got["port"][2][row]) == len(PROMPT)


def test_prefill_logits_last_row_is_prefills(models):
    """The last position of prefill_logits is prefill's logits (the LM head
    over all positions or the last one alone: f32 rounding apart)."""
    m = models["port"]
    a = Engine(m.params, m.config, max_seq=MAX_SEQ, dtype=torch.float32, device="cpu")
    b = Engine(m.params, m.config, max_seq=MAX_SEQ, dtype=torch.float32, device="cpu")
    np.testing.assert_allclose(a.prefill_logits(PROMPT)[-1], b.prefill(PROMPT),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("draft_layers,p_min,seeded", [
    (None, 0.0, False), (2, 0.0, False), (2, 0.0, True), (2, 0.02, False)])
def test_speculative_decoder_generate_matches_jax(models, draft_layers, p_min, seeded):
    """SpeculativeDecoder.generate: the tokens, the stats and both rows'
    lengths, greedy and with a seeded sampler chain (the draws in the JAX
    loop's order), with the same-weights draft (full acceptance) and a
    2-layer one, and with a p_min gate that stops some drafts early."""
    got = {}
    for side in ("jax", "port"):
        t, d, mod = _pair(models, side, draft_layers)
        spec = mod.SpeculativeDecoder(t, d, mod.SpeculativeParams(n_draft=4, p_min=p_min))
        sampler = None
        if seeded:
            if side == "jax":
                from llamacog_tpu.runtime.sampler import SamplerChain as JaxChain
                from llamacog_tpu.runtime.sampler import SamplerParams as JaxParams

                sampler = JaxChain(JaxParams(seed=7), n_vocab=t.config.n_vocab)
            else:
                sampler = SamplerChain(SamplerParams(seed=7), n_vocab=t.config.n_vocab)
        toks, stats = spec.generate(PROMPT, 14, sampler=sampler)
        got[side] = (toks, stats, int(t.seq_len[0]), int(d.seq_len[0]))
    assert got["port"] == got["jax"]
    toks, stats = got["port"][:2]
    assert len(toks) == 14 and stats["rounds"] > 0 and stats["drafted"] > 0
    if draft_layers is None and not seeded:
        assert stats["accepted"] >= stats["drafted"] * 0.5


def test_speculative_decoder_greedy_equals_plain_greedy(models):
    m = models["port"]
    ref = Engine(m.params, m.config, max_seq=MAX_SEQ, dtype=torch.float32, device="cpu")
    want = ref.generate_greedy(PROMPT, 20).tokens
    t, d, _ = _pair(models, "port", 2)
    got, _ = SpeculativeDecoder(t, d, SpeculativeParams(n_draft=4, p_min=0.0)).generate(
        PROMPT, 20)
    assert got == want


def test_step_slot_on_row_1_matches_jax(models):
    """Rounds of step_slot on row 1 of 2-row engines (row 0 holds another
    prompt) with max_accept 2: the accepted tokens, the next token, the
    slot's stats and every row's lengths."""
    got = {}
    for side in ("jax", "port"):
        t, d, mod = _pair(models, side, None, batch_size=2)
        for e in (t, d):
            e.prefill(PROMPT2, row=0)
            e.prefill(PROMPT, row=1)
        spec = mod.SpeculativeDecoder(t, d, mod.SpeculativeParams(n_draft=4, p_min=0.0))
        last = int(np.argmax(np.asarray(t.decode_one(np.array([0, PROMPT[-1]]),
                                                     active=np.array([False, True])))[1]))
        d.decode_one(np.array([0, PROMPT[-1]]), active=np.array([False, True]))
        stats, rounds = {}, []
        for _ in range(3):
            acc, nxt = spec.step_slot(1, last, lambda lg: int(np.argmax(lg)), 2, stats)
            rounds.append((acc, nxt, t.seq_len.tolist(), d.seq_len.tolist()))
            last = nxt
        got[side] = (rounds, stats)
    assert got["port"] == got["jax"]
    assert all(len(acc) <= 2 for acc, *_ in got["port"][0])


@pytest.fixture(scope="module")
def jax_on_device(models):
    """The JAX loop's result for the same-weights and the 1-layer drafts at
    k = 4, n = N_SPEC (one compile each): (tokens, stats, lengths)."""
    out = {}
    for layers in (None, 1):
        t, d, mod = _pair(models, "jax", layers)
        first = int(np.argmax(t.prefill(PROMPT)))
        d.prefill(PROMPT)
        toks, stats = mod.OnDeviceSpeculative(t, d, k=4).generate_greedy(first, N_SPEC)
        out[layers] = (np.asarray(toks).tolist(), stats, int(t.seq_len[0]), int(d.seq_len[0]))
    return out


def _port_on_device(models, layers, k, n=N_SPEC):
    t, d, _ = _pair(models, "port", layers)
    first = int(np.argmax(t.prefill(PROMPT)))
    d.prefill(PROMPT)
    spec = OnDeviceSpeculative(t, d, k=k)
    toks, stats = spec.generate_greedy(first, n)
    return toks, stats, t, d, spec


def _port_greedy(models, n=N_SPEC):
    m = models["port"]
    eng = Engine(m.params, m.config, max_seq=MAX_SEQ, dtype=torch.float32, device="cpu")
    first = int(np.argmax(eng.prefill(PROMPT)))
    return eng.decode_greedy_tokens([first], n)[0]


@pytest.mark.parametrize("layers", [None, 1])
def test_on_device_matches_the_jax_loop(models, jax_on_device, layers):
    """OnDeviceSpeculative: the tokens, the stats (rounds, drafted, accepted,
    accept rate) and both rows' final lengths of the JAX while_loop."""
    toks, stats, t, d, spec = _port_on_device(models, layers, 4)
    assert (toks.tolist(), stats, int(t.seq_len[0]), int(d.seq_len[0])) == \
        jax_on_device[layers]
    assert toks.dtype == np.int32 and toks.shape == (N_SPEC,)
    assert spec.replays == stats["rounds"] and spec.host_reads >= 3


def test_on_device_same_weights_is_greedy_exact_and_fully_accepted(models):
    toks, stats, t, _, _ = _port_on_device(models, None, 4)
    np.testing.assert_array_equal(toks, _port_greedy(models))
    assert stats["accept_rate"] == 1.0
    # the rows cover the prompt, the first token and the emitted ones, and
    # may run past by up to one round's k
    assert len(PROMPT) + 1 + N_SPEC <= int(t.seq_len[0]) <= len(PROMPT) + 1 + N_SPEC + 4


@pytest.mark.parametrize("layers,k", [(1, 3), (3, 2)])
def test_on_device_truncated_draft_is_greedy_exact(models, layers, k):
    toks, stats, _, _, _ = _port_on_device(models, layers, k, 20)
    np.testing.assert_array_equal(toks, _port_greedy(models, 20))
    assert 0.0 <= stats["accept_rate"] <= 1.0 and stats["rounds"] >= 1


def test_on_device_k1_and_k4_agree(models):
    want = _port_greedy(models, 12)
    for k in (1, 4):
        toks, _, _, _, _ = _port_on_device(models, None, k, 12)
        np.testing.assert_array_equal(toks, want)


def test_on_device_eager_and_replayed_rounds_agree(models):
    """generate_greedy(eager=True) calls the round from Python: on the CPU the
    same function as the default path, so the tokens and lengths agree."""
    a = _port_on_device(models, 2, 3)
    t, d, _ = _pair(models, "port", 2)
    first = int(np.argmax(t.prefill(PROMPT)))
    d.prefill(PROMPT)
    toks, stats = OnDeviceSpeculative(t, d, k=3).generate_greedy(first, N_SPEC, eager=True)
    assert toks.tolist() == a[0].tolist() and stats == a[1]
    assert (int(t.seq_len[0]), int(d.seq_len[0])) == (int(a[2].seq_len[0]),
                                                      int(a[3].seq_len[0]))


def test_on_device_refuses_a_full_context(models):
    t, d, _ = _pair(models, "port", 1)
    t.prefill(list(range(2, 120)))
    d.prefill(list(range(2, 120)))
    with pytest.raises(ValueError, match="context full"):
        OnDeviceSpeculative(t, d, k=4).generate_greedy(5, 16)


def test_truncated_draft_params_share_every_tensor(models):
    p = models["port"].params
    d = truncated_draft_params(p, 2)
    assert len(d["layers"]) == 2 and len(p["layers"]) == 4
    assert all(d["layers"][i] is p["layers"][i] for i in range(2))
    assert all(d[k] is p[k] for k in p if k != "layers")


def test_speculation_over_the_ring_is_refused_by_name(tmp_path):
    """A model with a sliding window shorter than max_seq keeps the ring
    (SwaKVCache) on a dense engine; both speculative modes refuse it."""
    from .test_torch_arch_qwen import write_gguf

    path = write_gguf(str(tmp_path / "g2.gguf"), "gemma2", post_norms=True, tied=True,
                      metadata={"gemma2.attention.sliding_window": 8})
    m = load_model(path, dtype=torch.float32, device="cpu")
    ring = Engine(m.params, m.config, max_seq=64, dtype=torch.float32, device="cpu")
    full = Engine(m.params, m.config, max_seq=64, dtype=torch.float32, device="cpu",
                  kv_type="bf16")
    assert ring.ring and not full.ring
    for t, d in ((ring, full), (full, ring)):
        with pytest.raises(ValueError, match="sliding-window ring"):
            SpeculativeDecoder(t, d)
        with pytest.raises(ValueError, match="sliding-window ring"):
            OnDeviceSpeculative(t, d)
    SpeculativeDecoder(full, full)  # the full store takes it


def test_ngram_cache_draft():
    c = NgramCache()
    c.update([1, 2, 3, 4, 1, 2, 3, 4, 1, 2, 3, 4])
    assert c.draft([1, 2, 3], n_draft=4)[:1] == [4]


def test_ngram_cache_save_merge_and_cross_load(tmp_path):
    """save/load/merge as tests/test_speculative.py:53-60; a file saved by
    either package loads in the other with the same parts."""
    from llamacog_tpu.runtime.ngram_cache import NgramCache as JaxNgramCache

    a = NgramCache()
    a.update([1, 2, 3, 1, 2, 3])
    b = NgramCache()
    b.update([1, 2, 4, 1, 2, 4])
    a.save(tmp_path / "a.bin")
    a2 = NgramCache.load(tmp_path / "a.bin")
    a2.merge(b)
    d = a2.parts[(1, 2)]
    assert d.get(3) and d.get(4)
    assert dict(JaxNgramCache.load(tmp_path / "a.bin").parts) == dict(a.parts)
    j = JaxNgramCache()
    j.update([5, 6, 7, 5, 6, 7, 5, 6])
    j.save(tmp_path / "j.bin")
    p = NgramCache.load(tmp_path / "j.bin")
    assert dict(p.parts) == dict(j.parts)
    assert p.draft([5, 6], n_draft=3) == j.draft([5, 6], n_draft=3)
