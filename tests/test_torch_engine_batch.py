"""The port's B-row engine (runtime/engine.py at batch_size 3) against the JAX
engine, on the CPU.

Both engines load the same tiny GGUFs (a Q4_K llama at n_embd 256, and a
Q4_K 4-expert MoE) in f32, the JAX side through its Pallas kernels in
interpret mode, and get the same calls: row prefills (the port runs each at
B = 1 over the row's view of the cache), decode steps with rows left
inactive, clear_row, set_seq_len with a second prefill on the kept prefix,
copy_row, shift_row, a full idle row while the others decode, and
generate_greedy. Logits of the rows that ran agree within LOGITS_TOL of the
largest |logit| (both sides multiply f32 operands and differ in summation
order only); greedy tokens and lengths are equal; the caches agree over each
row's valid slots (dense: within CACHE_TOL of the largest |value|;
quantized: dequantized, each value within one quantization step, since a
summation-order difference can move a value across a rounding boundary,
and CACHE_TOL elsewhere).

The JAX package's quantized-cache prefill rounds the dequantized old K/V to
bf16 before it attends them, even in an f32 model (QuantKVCache.read's
default dtype on its masked path, and its prefill kernel's tiles); the
port's plain version of K7 keeps them in f32. So the quantized caches run
twice: once with the port's plain dequant of the old planes rounded to bf16
the same way (_bf16_old_planes), where both sides compute the same function
and every step holds LOGITS_TOL; and once as the port ships, where the steps
from the first prefill chunk over old quantized planes on part from the JAX
engine's by that rounding, held within OLD_PLANES_TOL.

Where the two differ by design: a row that is not active in a decode step
writes nothing in the port; the JAX engine writes its K/V one slot past the
row's length, and on a full row (seq_len == max_seq) its clamped write
lands on the row's last valid slot. The test holds the port's full idle row
unchanged bit for bit.
"""

import numpy as np
import pytest
import torch

from llamacog_tpu_torch.models.loader import load_model
from llamacog_tpu_torch.runtime.engine import Engine
from llamacog_tpu_torch.runtime.kv_cache import QuantKVCache

LOGITS_TOL = 1e-4  # of max |logit|
# the port's f32 old planes against the JAX engine's bf16-rounded ones, from
# the first prefill chunk over old quantized planes on: that chunk's logits
# moved by 2.3e-3 (q8_0) and 1.9e-3 (q4_0) of max |logit|, the decode step
# after it by 1.2e-3 and 4.1e-3, and 8.2% and 6.9% of row 0's cached values
# (its layer-1 K/V of those slots) moved past CACHE_TOL, each still within
# one quantization step
OLD_PLANES_TOL = 1e-2
OLD_PLANES_MOVED = 0.2  # share of a row's values past CACHE_TOL
CACHE_TOL = 1e-4   # of max |cache value|
B = 3
MAX_SEQ = 64
# the largest step of one quantized value, as a fraction of the group's
# largest |value| (q8_0: d = amax / 127; q4_0: d = vmax / -8)
QUANT_STEP = {"q8_0": 1 / 127, "q4_0": 1 / 8}


@pytest.fixture
def _bf16_old_planes(monkeypatch):
    """The port's plain K7 with the old planes' dequant rounded to bf16
    (its decode plain version keeps f32, as the JAX decode does)."""
    from llamacog_tpu_torch.ops.cuda import flash_q8

    deq, plain = flash_q8._deq_layer, flash_q8.flash_prefill_q8_plain

    def prefill_plain(*a, **kw):
        monkeypatch.setattr(flash_q8, "_deq_layer",
                            lambda *d: deq(*d).to(torch.bfloat16).float())
        try:
            return plain(*a, **kw)
        finally:
            monkeypatch.setattr(flash_q8, "_deq_layer", deq)

    monkeypatch.setattr(flash_q8, "flash_prefill_q8_plain", prefill_plain)


@pytest.fixture(scope="module")
def ggufs(tmp_path_factory):
    from llamacog_tpu.gguf import GGMLType
    from llamacog_tpu.utils.testing import make_tiny_llama_gguf

    d = tmp_path_factory.mktemp("batch")
    q4k = make_tiny_llama_gguf(str(d / "q4k.gguf"), n_embd=256, n_head=4, n_head_kv=2,
                               n_ff=512, quant_type=GGMLType.Q4_K)
    moe = make_tiny_llama_gguf(str(d / "moe.gguf"), n_embd=256, n_ff=512, n_expert=4,
                               n_expert_used=2, quant_type=GGMLType.Q4_K,
                               extra_metadata={"llama.expert_weights_norm": True})
    return {"q4k": q4k, "moe": moe}


def _engines(path, kv_type="dense", batch=B, max_seq=MAX_SEQ):
    import jax.numpy as jnp

    from llamacog_tpu.models.loader import load_model as jax_load_model
    from llamacog_tpu.runtime.engine import Engine as JaxEngine

    m = jax_load_model(path, with_tokenizer=False, dtype=jnp.float32)
    ref = JaxEngine(m.params, m.config, batch_size=batch, max_seq=max_seq,
                    dtype=jnp.float32, kv_type=kv_type)
    m = load_model(path, dtype=torch.float32, device="cpu", with_tokenizer=False)
    eng = Engine(m.params, m.config, batch_size=batch, max_seq=max_seq, dtype=torch.float32,
                 kv_type=kv_type, device="cpu")
    return ref, eng


def _close(got, want, what, tol=LOGITS_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"{what}: max err {err:.3e} of max |logit|"


def _caches(ref, eng):
    """Both caches as f32 numpy [(k, v)] of shape [L, B, S, Hkv, D]."""
    import jax.numpy as jnp

    c, r = eng.cache, ref.cache
    if isinstance(c, QuantKVCache):
        got = (c.dequant_k(c.k_planes, torch.float32), c.dequant_v(c.v_planes, torch.float32))
        want = (r.dequant_k(r.k_planes, jnp.float32), r.dequant_v(r.v_planes, jnp.float32))
    else:
        got, want = (c.k, c.v), (r.k, r.v)
    return [(np.asarray(g, np.float32), np.asarray(w, np.float32)) for g, w in zip(got, want)]


def _check_caches(ref, eng, kv_type, rows=range(B), moved=0.01):
    np.testing.assert_array_equal(eng.seq_len, ref.seq_len)
    for got, want in _caches(ref, eng):
        for b in rows:
            n = int(eng.seq_len[b])
            g, w = got[:, b, :n], want[:, b, :n]
            diff = np.abs(g - w)
            top = max(float(np.abs(w).max()) if n else 0.0, 1e-30)
            if kv_type == "dense":
                assert diff.max() <= CACHE_TOL * top, f"row {b}: {diff.max():.3e}"
            else:
                assert diff.max() <= QUANT_STEP[kv_type] * top * 1.001, f"row {b}"
                assert (diff > CACHE_TOL * top).mean() < moved, f"row {b}"


def _both(ref, eng, fn):
    return [fn(e) for e in (ref, eng)]


PROMPTS = ([3, 17, 9, 41, 200, 5, 77], [11, 23, 5, 140], [8, 90, 33, 2, 61, 7, 120, 44, 19])


def _scenario(ref, eng, kv_type, old_tol=LOGITS_TOL, old_moved=0.01):
    """The engine calls of a server's slots, on both engines, with each
    step's logits held together: within LOGITS_TOL, and from the first
    prefill chunk over old cache slots (after set_seq_len) on within
    old_tol, with the caches' share of moved values below old_moved."""
    tol = LOGITS_TOL
    toks = np.zeros(B, dtype=np.int32)
    for row, prompt in enumerate(PROMPTS):
        want, got = _both(ref, eng, lambda e: np.asarray(e.prefill(prompt, row=row)))
        _close(got, want, f"prefill row {row}")
        toks[row] = int(np.argmax(want))
    _check_caches(ref, eng, kv_type)

    def decode(active, what):
        want, got = _both(ref, eng, lambda e: np.asarray(e.decode_one(toks, active=active)))
        rows = [b for b in range(B) if active is None or active[b]]
        for b in rows:
            _close(got[b], want[b], f"{what}, row {b}", tol)
            toks[b] = int(np.argmax(want[b]))
        return rows

    decode(None, "decode all rows")
    decode(np.array([True, False, True]), "decode, row 1 inactive")
    _check_caches(ref, eng, kv_type)
    decode(np.array([True, True, True]), "decode after an inactive step")
    _both(ref, eng, lambda e: e.copy_row(0, 1))
    toks[1] = toks[0]
    _check_caches(ref, eng, kv_type)
    decode(None, "decode after copy_row(0, 1)")
    _both(ref, eng, lambda e: e.shift_row(2, 3, 4))
    _check_caches(ref, eng, kv_type)
    decode(None, "decode after shift_row(2, 3, 4)")
    decode(None, "decode 2 after shift_row")
    # prefix reuse: keep row 0's first 5 tokens, prefill a new suffix there
    _both(ref, eng, lambda e: e.set_seq_len(0, 5))
    tol = old_tol
    want, got = _both(ref, eng, lambda e: np.asarray(e.prefill([50, 51, 52], row=0)))
    _close(got, want, "prefill after set_seq_len(0, 5)", tol)
    toks[0] = int(np.argmax(want))
    _both(ref, eng, lambda e: e.clear_row(1))
    want, got = _both(ref, eng, lambda e: np.asarray(e.prefill(PROMPTS[1][:3], row=1)))
    _close(got, want, "prefill after clear_row(1)", tol)
    toks[1] = int(np.argmax(want))
    decode(None, "decode after set_seq_len and clear_row")
    _check_caches(ref, eng, kv_type, moved=old_moved)


@pytest.mark.parametrize("model,kv_type", [("q4k", "dense"), ("q4k", "q8_0"),
                                           ("q4k", "q4_0"), ("moe", "dense")])
def test_row_calls_match_jax(ggufs, model, kv_type, _bf16_old_planes):
    ref, eng = _engines(ggufs[model], kv_type)
    _scenario(ref, eng, kv_type)


@pytest.mark.parametrize("kv_type", ["q8_0", "q4_0"])
def test_row_calls_match_jax_with_f32_old_planes(ggufs, kv_type):
    """The same calls with the port's plain K7 as it ships (the old planes
    in f32): equal to the JAX engine's within LOGITS_TOL up to the first
    prefill chunk over old quantized planes, within OLD_PLANES_TOL after."""
    ref, eng = _engines(ggufs["q4k"], kv_type)
    _scenario(ref, eng, kv_type, OLD_PLANES_TOL, OLD_PLANES_MOVED)


@pytest.mark.parametrize("kv_type", ["dense", "q8_0"])
def test_full_idle_row_writes_nothing(ggufs, kv_type):
    """Row 2 at seq_len == max_seq stays inactive while rows 0 and 1 decode:
    its cache stays bit for bit as it was (the write index never leaves
    [0, S)), and the other rows match the JAX engine's."""
    ref, eng = _engines(ggufs["q4k"], kv_type)
    long_prompt = [(7 * j + 3) % 256 for j in range(MAX_SEQ)]
    toks = np.zeros(B, dtype=np.int32)
    for row, prompt in enumerate((PROMPTS[0], PROMPTS[1], long_prompt)):
        want, got = _both(ref, eng, lambda e: np.asarray(e.prefill(prompt, row=row)))
        _close(got, want, f"prefill row {row}")
        toks[row] = int(np.argmax(want))
    assert int(eng.seq_len[2]) == MAX_SEQ
    before = [p[:, 2].clone() for p in eng.cache.planes()]
    active = np.array([True, True, False])
    for step in range(4):
        want, got = _both(ref, eng, lambda e: np.asarray(e.decode_one(toks, active=active)))
        for b in (0, 1):
            _close(got[b], want[b], f"step {step}, row {b}")
            toks[b] = int(np.argmax(want[b]))
    for p, old in zip(eng.cache.planes(), before):
        assert torch.equal(p[:, 2], old)
    _check_caches(ref, eng, kv_type, rows=(0, 1))
    with pytest.raises(ValueError, match="context full"):
        eng.decode_one(toks, active=np.array([False, False, True]))


def test_generate_greedy_matches_jax(ggufs):
    """generate_greedy at B = 3: row 0's prompt, the greedy loop over every
    row; the tokens and every row's length equal the JAX engine's."""
    ref, eng = _engines(ggufs["q4k"])
    want, got = _both(ref, eng, lambda e: e.generate_greedy(PROMPTS[2], 12).tokens)
    assert got == want and len(got) == 12
    np.testing.assert_array_equal(eng.seq_len, ref.seq_len)
    greedy = _both(ref, eng, lambda e: np.asarray(e.decode_greedy_tokens(
        np.array([want[-1]] * B), 5)))
    np.testing.assert_array_equal(greedy[1], greedy[0])


def test_row_prefill_costs_one_row(ggufs, monkeypatch):
    """A row's prefill runs the forward at B = 1 (one prompt's FLOPs, not B
    times) and leaves the other rows' caches untouched."""
    from llamacog_tpu_torch.runtime import engine as engine_mod

    _, eng = _engines(ggufs["q4k"])
    eng.prefill(PROMPTS[0], row=0)
    shapes = []
    real = engine_mod.forward

    def spy(params, cfg, tokens, *a, **kw):
        shapes.append(tuple(tokens.shape))
        return real(params, cfg, tokens, *a, **kw)

    monkeypatch.setattr(engine_mod, "forward", spy)
    others = [p[:, 0].clone() for p in eng.cache.planes()]
    eng.prefill(PROMPTS[1], row=1)
    assert shapes == [(1, 32)]
    assert all(torch.equal(p[:, 0], o) for p, o in zip(eng.cache.planes(), others))
    with pytest.raises(ValueError, match="out of range"):
        eng.prefill(PROMPTS[1], row=B)
