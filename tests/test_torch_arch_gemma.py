"""The Gemma families of the generalized transformer in the port (gemma,
gemma2, gemma3) and the sliding-window ring cache, held against the JAX
package.

Tiny random GGUFs (tests/test_torch_arch_qwen.py::write_gguf): gemma2
with its softcaps (attention 50, final 30) and a window of 8 on every
other layer; gemma3 at 6 layers (pattern 6: five local layers, one
global) with per-head q/k norms, its local layers' rope table (base
10000) beside a linearly scaled global one, and a window of 8. At
max_seq 64 the window is shorter than the cache, so a dense engine keeps
the ring (SwaKVCache); kv "bf16" keeps the full store (the window then
held by the masks and kernels), and q8_0 the quantized planes. Prompts run
past the window and decode wraps the ring several times. The cases of
tests/test_swa_ring.py are mirrored on the port, and the two row
operations a ring cannot take (shift_row, a truncating set_seq_len) are
each stated against the JAX package's behavior. Gemma-1 (gemma): the
embedding scale and the GELU FFN without post norms or a window, q 128
wide over n_embd 64 as Gemma-7B's over its 3072, with the dense and the
q8_0 cache.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llamacog_tpu.models.loader import load_model as jax_load_model
from llamacog_tpu.runtime.engine import Engine as JaxEngine
from llamacog_tpu_torch.models.loader import load_model
from llamacog_tpu_torch.runtime.engine import Engine
from llamacog_tpu_torch.runtime.kv_cache import KVCache, QuantKVCache, SwaKVCache
from llamacog_tpu_torch.server.server import ServerContext

from .test_torch_arch_qwen import TOL, check_same_run, load_both, write_gguf

WINDOW = 8
MAX_SEQ = 64
PROMPT = [(i * 37) % 250 + 3 for i in range(20)]  # > WINDOW
N_DECODE = 24  # the ring of 8 wraps three times
CASES = {
    "gemma2": dict(arch="gemma2", post_norms=True, tied=True,
                   metadata={"gemma2.attention.sliding_window": WINDOW,
                             "gemma2.attn_logit_softcapping": 50.0,
                             "gemma2.final_logit_softcapping": 30.0}),
    "gemma3": dict(arch="gemma3", post_norms=True, tied=True, qk_norm=True, n_layer=6,
                   head_dim=32, metadata={"gemma3.attention.sliding_window": WINDOW,
                                          "gemma3.rope.freq_base": 1e6,
                                          "gemma3.rope.scaling.type": "linear",
                                          "gemma3.rope.scaling.factor": 8.0}),
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("arch_gemma")
    return {name: write_gguf(str(root / f"{name}.gguf"), **case)
            for name, case in CASES.items()}


@pytest.mark.parametrize("kv_type", ["dense", "bf16", "q8_0"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_greedy_tokens_match_jax(files, case, kv_type):
    eng = check_same_run(files[case], kv_type, PROMPT, N_DECODE, MAX_SEQ)
    want = {"dense": SwaKVCache, "bf16": KVCache, "q8_0": QuantKVCache}[kv_type]
    assert type(eng.cache) is want


@pytest.fixture(scope="module")
def gemma1_file(tmp_path_factory):
    return write_gguf(str(tmp_path_factory.mktemp("arch_gemma1") / "gemma1.gguf"), "gemma",
                      tied=True, n_head=4, n_head_kv=4, head_dim=32)


@pytest.mark.parametrize("kv_type", ["dense", "q8_0"])
def test_gemma1_tokens_match_jax(gemma1_file, kv_type):
    eng = check_same_run(gemma1_file, kv_type)
    cfg = eng.config
    assert (cfg.embd_scale, cfg.ffn_act, cfg.post_norms) == (8.0, "gelu", False)
    assert type(eng.cache) is (KVCache if kv_type == "dense" else QuantKVCache)


def test_config_follows_the_arch(files):
    cfg = load_model(files["gemma3"], device="cpu", with_tokenizer=False).config
    assert [cfg.is_swa(il) for il in range(6)] == [True] * 5 + [False]
    assert cfg.rope_swa.freq_base == 10000.0 and cfg.rope.scaling_factor == 8.0
    assert cfg.kq_scale == pytest.approx(32 ** -0.5) and cfg.embd_scale == 8.0
    cfg2 = load_model(files["gemma2"], device="cpu", with_tokenizer=False).config
    assert (cfg2.attn_logit_softcap, cfg2.final_logit_softcap) == (50.0, 30.0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_ring_planes_equal_the_jax_ring(files, case):
    """After a prefill past the window and decode steps that wrap the ring,
    every layer's ring (its W live slots) and full store equal the JAX
    cache's: the same slots hold the same K/V (f32 models)."""
    ref, eng, _ = load_both(files[case], batch_size=1, max_seq=MAX_SEQ)
    first = np.array([int(np.argmax(np.asarray(ref.prefill(PROMPT))))])
    eng.prefill(PROMPT)
    ref.decode_greedy_tokens(first, 11)
    eng.decode_greedy_tokens(first, 11)
    rc, pc = ref.cache, eng.cache
    assert pc.swa_layers == rc.swa_layers and pc.window == rc.window == WINDOW
    for a, b in ((pc.k_swa, rc.k_swa), (pc.v_swa, rc.v_swa)):
        want = np.asarray(b)[:, :, :WINDOW]
        np.testing.assert_allclose(a[:, :, :WINDOW].numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    n = len(PROMPT) + 11
    for a, b in ((pc.full.k, rc.full.k), (pc.full.v, rc.full.v)):
        want = np.asarray(b)[:, :, :n]
        np.testing.assert_allclose(a[:, :, :n].numpy(), want, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(want).max(), 1e-30))


def _engine(path, **kw):
    m = load_model(path, dtype=torch.float32, device="cpu", with_tokenizer=False)
    return Engine(m.params, m.config, dtype=torch.float32, device="cpu", **kw)


def test_ring_selected(files):
    eng = _engine(files["gemma2"], batch_size=2, max_seq=MAX_SEQ)
    assert isinstance(eng.cache, SwaKVCache) and eng.ring
    assert eng.cache.window == WINDOW
    assert eng.cache.k_swa.shape[2] == WINDOW + 1  # window + the write dump
    assert eng.cache.full.k.shape[0] == 1  # one of the 2 layers is global
    # a window as long as the cache keeps the full store
    assert isinstance(_engine(files["gemma2"], max_seq=WINDOW).cache, KVCache)


def test_ring_matches_full_cache(files):
    """The ring against the full store with window masks, in the port
    alone: a prefill past the window, decode far past it, a second prefill
    on top (tests/test_swa_ring.py::test_ring_matches_full_cache)."""
    ring = _engine(files["gemma3"], batch_size=2, max_seq=MAX_SEQ)
    full = _engine(files["gemma3"], batch_size=2, max_seq=MAX_SEQ, kv_type="bf16")
    assert isinstance(full.cache, KVCache)
    lr, lf = ring.prefill(PROMPT[:12]), full.prefill(PROMPT[:12])
    np.testing.assert_allclose(lr, lf, rtol=2e-5, atol=2e-5)
    tok = int(np.argmax(lf))
    for _ in range(20):
        lr = ring.decode_one(np.array([tok, 0]))[0]
        lf = full.decode_one(np.array([tok, 0]))[0]
        np.testing.assert_allclose(lr, lf, rtol=2e-5, atol=2e-5)
        tok = int(np.argmax(lf))
    np.testing.assert_allclose(ring.prefill([5, 6, 7]), full.prefill([5, 6, 7]),
                               rtol=2e-5, atol=2e-5)


def test_ring_multirow_isolation(files):
    ring = _engine(files["gemma2"], batch_size=2, max_seq=MAX_SEQ)
    full = _engine(files["gemma2"], batch_size=2, max_seq=MAX_SEQ, kv_type="bf16")
    for e in (ring, full):
        e.prefill([3, 9, 17, 4, 25, 11, 7, 2, 13], row=0)
        e.prefill([8, 1, 2], row=1)  # must not disturb row 0's ring
    np.testing.assert_allclose(ring.decode_one(np.array([5, 6])),
                               full.decode_one(np.array([5, 6])), rtol=2e-5, atol=2e-5)


def test_two_rows_row_prefill_and_copy_row_match_jax(files):
    """A 2-row engine: a row prefill of row 0 past the window, copy_row to
    row 1, decode steps of both rows (row 1 inactive in one), against the
    JAX engine's same calls; the copied row's logits equal row 0's."""
    ref, eng, _ = load_both(files["gemma2"], batch_size=2, max_seq=MAX_SEQ)
    want = np.asarray(ref.prefill(PROMPT, row=0))
    got = eng.prefill(PROMPT, row=0)
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()
    ref.copy_row(0, 1)
    eng.copy_row(0, 1)
    for step, active in enumerate([None, np.array([True, False]), None] * 4):
        toks = np.array([11 + step, 11 + step])
        want = np.asarray(ref.decode_one(toks, active=active))
        got = eng.decode_one(toks, active=active)
        for r in range(2):
            if active is None or active[r]:
                assert np.abs(got[r] - want[r]).max() <= TOL * np.abs(want[r]).max(), (step, r)
        if step == 0:  # the copy holds row 0's cache: the same token, the same logits
            np.testing.assert_array_equal(got[0], got[1])
    np.testing.assert_array_equal(eng.seq_len, np.asarray(ref.seq_len))


def test_shift_row_on_a_ring(files):
    """The JAX engine's shift_fn reads cache.k, which its SwaKVCache lacks:
    it raises AttributeError (ROADMAP §3.11). The port refuses the shift by
    name, and its server runs with context shift off on such a model."""
    ref, eng, got = load_both(files["gemma2"], batch_size=1, max_seq=MAX_SEQ)
    ref.prefill(PROMPT)
    eng.prefill(PROMPT)
    with pytest.raises(AttributeError):
        ref.shift_row(0, 4, 8)
    with pytest.raises(NotImplementedError, match="ring"):
        eng.shift_row(0, 4, 8)
    assert not ServerContext(got, n_slots=1, ctx_size=MAX_SEQ, dtype=torch.float32,
                             device="cpu").ctx_shift


def test_cli_shifts_a_gemma_context(files, capsys):
    """tools/cli.py's -ctk kinds (bf16 by default, as the JAX CLI's) name
    the full store, never the ring, so a windowed model past its context
    shifts (Engine.shift_row) and generates on instead of raising."""
    from llamacog_tpu_torch.tools import cli

    assert cli.main(["-m", files["gemma2"], "--device", "cpu", "--dtype", "f32", "--greedy",
                     "-c", str(MAX_SEQ), "-n", "200", "-p", "hello"]) == 0
    err = capsys.readouterr().err
    n_prompt = int(err.split("prompt: ")[1].split()[0])
    n_gen = int(err.split("decode: ")[1].split()[0])
    assert n_gen == 200 and n_prompt + n_gen > 2 * MAX_SEQ


def test_truncated_ring_row(files, tmp_path):
    """Prefix reuse truncates a row (set_seq_len below its length) and
    prefills the rest. On a ring the JAX engine then computes from ring
    slots that hold positions past the new length: its logits differ from a
    fresh prefill (ROADMAP §3.11). The port's engine refuses the truncation,
    and its server prefills such a slot anew: a request sharing part of the
    slot's tokens gets the tokens of a fresh server."""
    path = files["gemma2"]
    head, tail = PROMPT[:12], [40, 41, 42, 43, 44]
    ref = jax_load_model(path, with_tokenizer=False, dtype=jnp.float32)
    jax_eng = JaxEngine(ref.params, ref.config, batch_size=1, max_seq=MAX_SEQ,
                        dtype=jnp.float32)
    jax_eng.prefill(PROMPT)
    jax_eng.set_seq_len(0, len(head))
    reused = np.asarray(jax_eng.prefill(tail))
    jax_eng.clear_row(0)
    fresh = np.asarray(jax_eng.prefill(head + tail))
    assert np.abs(reused - fresh).max() > 1e-2 * np.abs(fresh).max()

    eng = _engine(path, max_seq=MAX_SEQ)
    eng.prefill(PROMPT)
    with pytest.raises(ValueError, match="cannot be truncated"):
        eng.set_seq_len(0, len(head))

    m = load_model(path, dtype=torch.float32, device="cpu")

    def serve(prompts):
        ctx = ServerContext(m, n_slots=1, ctx_size=MAX_SEQ, dtype=torch.float32, device="cpu")
        tasks = [ctx.make_task({"prompt": p, "n_predict": 6, "temperature": 0,
                                "return_tokens": True}, "completion") for p in prompts]
        for t in tasks:
            ctx.pending.put(t)
        ctx.start()
        try:
            out = []
            for t in tasks:
                while True:
                    msg = t.out.get(timeout=600)
                    assert "error" not in msg, msg
                    if msg.get("stop"):
                        out.append(msg)
                        break
            return out
        finally:
            ctx.stop()

    second = serve([PROMPT, head + tail])[1]
    alone = serve([head + tail])[0]
    assert second["tokens"] == alone["tokens"]
    assert second["timings"]["cache_n"] == 0
