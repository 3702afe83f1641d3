"""The port's decode-step holder (runtime/engine.py::DecodeStep) against the
JAX engine, on the CPU.

On the CPU the holder runs the step function eagerly into its static
buffers (the input token, the write offsets, the in-graph step index, the
output tokens and the logits); on the GPU the same step is a CUDA graph per
kv_cap bucket. Both packages load the same tiny GGUFs (a Q4_K_M llama and
a Q4_K MoE, as tests/test_torch_model.py and tests/test_torch_moe.py build
them) and run in f32, the JAX side through its Pallas kernels in interpret
mode. Greedy tokens and lengths must be equal; logits agree within the
model tests' f32 tolerance (atol 2e-3, rtol 1e-3: both sides multiply f32
operands and differ in summation order only).

The JAX package is imported inside the fixtures, not at the top: the GPU
machine has no JAX, and there this file's `-m cuda` case must still import
(`pytest --noconftest tests/test_torch_engine_graph.py -m cuda`).
"""

import numpy as np
import pytest
import torch

from llamacog_tpu_torch.models.llama import forward
from llamacog_tpu_torch.models.loader import load_model
from llamacog_tpu_torch.ops.cuda import build
from llamacog_tpu_torch.runtime.engine import Engine

PROMPT = [3, 17, 9, 41, 200, 5, 77]
PROMPT2 = [11, 23, 5, 140]
LOGITS_TOL = dict(atol=2e-3, rtol=1e-3)


@pytest.fixture(scope="module")
def ggufs(tmp_path_factory):
    from llamacog_tpu.gguf import GGMLType
    from llamacog_tpu.tools.quantize import main as quantize_main
    from llamacog_tpu.utils.testing import make_tiny_llama_gguf

    d = tmp_path_factory.mktemp("graph")
    src = str(d / "f32.gguf")
    make_tiny_llama_gguf(src, n_embd=256, n_head=4, n_head_kv=2, n_ff=512,
                         quant_type=GGMLType.F32)
    q4km = str(d / "q4km.gguf")
    assert quantize_main([src, q4km, "Q4_K_M"]) == 0
    moe = make_tiny_llama_gguf(str(d / "moe.gguf"), n_embd=256, n_ff=512, n_expert=4,
                               n_expert_used=2, quant_type=GGMLType.Q4_K,
                               extra_metadata={"llama.expert_weights_norm": True})
    return {"q4km": q4km, "moe": moe}


def _engines(path, kv_type="dense", max_seq=512):
    """The JAX engine and the port's, f32 on the CPU, on the same GGUF."""
    import jax.numpy as jnp

    from llamacog_tpu.models.loader import load_model as jax_load_model
    from llamacog_tpu.runtime.engine import Engine as JaxEngine

    m = jax_load_model(path, with_tokenizer=False, dtype=jnp.float32)
    ref = JaxEngine(m.params, m.config, batch_size=1, max_seq=max_seq, dtype=jnp.float32,
                    kv_type=kv_type)
    m = load_model(path, dtype=torch.float32, device="cpu", with_tokenizer=False)
    eng = Engine(m.params, m.config, batch_size=1, max_seq=max_seq, dtype=torch.float32,
                 kv_type=kv_type, device="cpu")
    return ref, eng


@pytest.mark.parametrize("model,kv_type", [("q4km", "dense"), ("q4km", "q8_0"),
                                           ("moe", "dense")])
def test_greedy_tokens_and_lengths_match_jax(ggufs, model, kv_type):
    ref, eng = _engines(ggufs[model], kv_type)
    got = []
    for e in (ref, eng):
        first = int(np.argmax(np.asarray(e.prefill(PROMPT))))
        got.append((np.asarray(e.decode_greedy_tokens(np.array([first]), 12)),
                    np.asarray(e.seq_len).copy()))
    (ref_toks, ref_len), (toks, seq_len) = got
    assert toks.shape == (1, 12) and toks.dtype == np.int32
    np.testing.assert_array_equal(toks, ref_toks)
    np.testing.assert_array_equal(seq_len, ref_len)
    assert int(seq_len[0]) == len(PROMPT) + 12


@pytest.mark.parametrize("kv_type", ["dense", "q8_0"])
def test_interleaved_decode_one_and_greedy_loops_match_jax(ggufs, kv_type):
    """prefill, 3 x decode_one, decode_greedy_tokens(8), a second prefill
    chunk, decode_greedy_tokens(8): the holder's buffers are reloaded at
    every call, and its step index restarts at 0."""
    runs = []
    for e in _engines(ggufs["q4km"], kv_type):
        toks, one_logits = [], []
        tok = int(np.argmax(np.asarray(e.prefill(PROMPT))))
        for _ in range(3):
            logits = np.asarray(e.decode_one(np.array([tok])))
            one_logits.append(logits)
            tok = int(np.argmax(logits[0]))
            toks.append(tok)
        loop = np.asarray(e.decode_greedy_tokens(np.array([tok]), 8))[0]
        toks += loop.tolist()
        tok = int(np.argmax(np.asarray(e.prefill(PROMPT2))))
        toks.append(tok)
        toks += np.asarray(e.decode_greedy_tokens(np.array([tok]), 8))[0].tolist()
        runs.append((toks, one_logits, int(e.seq_len[0])))
    (ref_toks, ref_logits, ref_len), (toks, logits, seq_len) = runs
    assert toks == ref_toks
    assert seq_len == ref_len == len(PROMPT) + 3 + 8 + len(PROMPT2) + 8
    for got, want in zip(logits, ref_logits):
        assert got.shape == want.shape == (1, 256)
        np.testing.assert_allclose(got, want, **LOGITS_TOL)


def test_decode_one_returns_a_copy(ggufs):
    """The logits decode_one returns do not change under later steps (the
    holder writes the next step's logits into the same buffer)."""
    _, eng = _engines(ggufs["q4km"])
    tok = int(np.argmax(eng.prefill(PROMPT)))
    first = eng.decode_one([tok])
    kept = first.copy()
    eng.decode_one([int(np.argmax(first[0]))])
    np.testing.assert_array_equal(first, kept)


@pytest.mark.parametrize("max_new,eog_at", [(12, None), (12, 4), (1, None)])
def test_generate_greedy_matches_jax(ggufs, max_new, eog_at):
    """max_new > 1 takes the greedy loop (stopping at an EOG id: the token
    the loop gives at position eog_at), max_new = 1 the decode_one loop."""
    ref, eng = _engines(ggufs["q4km"])
    eog = ()
    if eog_at is not None:
        eog = (ref.generate_greedy(PROMPT, max_new).tokens[eog_at],)
        ref.seq_len[:] = 0
    want = ref.generate_greedy(PROMPT, max_new, eog_ids=eog)
    got = eng.generate_greedy(PROMPT, max_new, eog_ids=eog)
    assert got.tokens == want.tokens
    assert int(eng.seq_len[0]) == int(ref.seq_len[0])
    if eog_at is not None:
        assert len(got.tokens) <= eog_at + 1 and got.tokens[-1] in eog


def test_crossing_a_kv_cap_bucket_matches_the_per_step_forward_loop(ggufs):
    """max_seq 4096, a 2036-token prompt, then 16 decode steps from depth
    2036: a greedy loop of 4 and 4 decode_one steps in the 2048 bucket, then
    a loop of 8 whose kv_cap is 4096. The reference is the port's own
    per-step forward loop (what decode_greedy_tokens ran before the holder)
    on a second engine with the same params and the same kv_cap per call:
    it isolates the holder's bucket switch from the model, which the tests
    above hold against JAX; a 2036-token prompt through the JAX engine in
    interpret mode would cost minutes here."""
    m = load_model(ggufs["q4km"], dtype=torch.float32, device="cpu", with_tokenizer=False)
    prompt = [(i * 37) % 250 + 3 for i in range(2036)]
    engines = [Engine(m.params, m.config, batch_size=1, max_seq=4096, dtype=torch.float32,
                      device="cpu") for _ in range(2)]
    eng, ref = engines
    caps = []
    step = eng._step

    def recording_step(tokens, write_pos, t, last_pos=None, kv_cap=None, **kw):
        caps.append(kv_cap)
        return step(tokens, write_pos, t, last_pos=last_pos, kv_cap=kv_cap, **kw)
    eng._step = recording_step

    def ref_steps(tok, n, kv_cap):
        """n steps of forward at T = 1 on `ref`, the argmax fed back."""
        out, logits_all = [], []
        tok = torch.tensor([tok])
        write_pos = torch.as_tensor(ref.seq_len.copy())
        for _ in range(n):
            positions = write_pos[:, None].long()
            logits, ref.cache = forward(ref.params, ref.config, tok[:, None], positions,
                                        ref.cache, write_pos, dtype=ref.dtype, kv_cap=kv_cap)
            logits_all.append(logits[:, 0].numpy().copy())
            tok = logits[:, 0].argmax(dim=-1)
            out.append(int(tok[0]))
            write_pos += 1
        ref.seq_len = ref.seq_len + n
        return out, logits_all

    firsts = [int(np.argmax(e.prefill(prompt))) for e in engines]
    assert firsts[0] == firsts[1]
    tok = firsts[0]
    got = eng.decode_greedy_tokens([tok], 4)[0].tolist()
    want, _ = ref_steps(tok, 4, ref._kv_cap(2036 + 4 + 1))
    for _ in range(4):
        logits = eng.decode_one([got[-1]])
        ref_tok, ref_logits = ref_steps(want[-1], 1, ref._kv_cap(int(ref.seq_len[0]) + 1))
        np.testing.assert_array_equal(logits, ref_logits[0])
        got.append(int(np.argmax(logits[0])))
        want += ref_tok
    got += eng.decode_greedy_tokens([got[-1]], 8)[0].tolist()
    want += ref_steps(want[-1], 8, ref._kv_cap(2044 + 8 + 1))[0]
    assert got == want
    assert int(eng.seq_len[0]) == int(ref.seq_len[0]) == 2036 + 16
    # after the prefill's: 4 loop steps and 4 decode_one steps in the 2048
    # bucket, then 8 loop steps in the 4096 one (on the CPU the holder calls
    # the step function once a step)
    assert caps[1:] == [2048] * 8 + [4096] * 8, caps


@pytest.mark.cuda
def test_graph_tokens_equal_eager_and_launches_count_replays():
    """On the card: a 2-layer model at the Llama-3-8B widths, 16 greedy
    tokens replayed from the captured step equal the same step run eagerly,
    and LAUNCHES adds the captured launches once a replay."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA graph has no CPU mode")
    from llamacog_tpu_torch.utils.synthetic import llama3_8b_config, make_synthetic_params

    cfg = llama3_8b_config(n_layer=2)
    eng = Engine(make_synthetic_params(cfg, seed=7), cfg, batch_size=1, max_seq=1024)
    prompt = [(i * 7919) % cfg.n_vocab for i in range(2, 22)]
    runs = {}
    for mode in ("graph", "eager", "graph"):
        eng.reset()
        first = int(eng.prefill(prompt).argmax())
        build.reset_launches()
        run = eng.decode_greedy_tokens if mode == "graph" else eng.decode_greedy_tokens_eager
        runs[mode] = (run([first], 16), dict(build.LAUNCHES))
    (graph, launches), (eager, eager_launches) = runs["graph"], runs["eager"]
    np.testing.assert_array_equal(graph, eager)
    assert len(eng.decoder.graphs) == 1
    (_, captured), = eng.decoder.graphs.values()
    assert captured["qmv"] > 0 and captured["flash_decode_dense"] == cfg.n_layer
    assert launches == {k: captured.get(k, 0) * 16 for k in build.LAUNCHES}
    assert launches == eager_launches
