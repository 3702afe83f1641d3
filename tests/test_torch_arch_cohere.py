"""The Command-R families in the port (command-r, cohere2), held against the
JAX package.

Tiny random GGUFs (tests/test_torch_arch_qwen.py::write_gguf): a layer
norm without a bias (attn_norm and output_norm only: the FFN reads the
attention's input norm, the parallel residual x + attn + ffn), the logit
scale, a tied head. Command-R all Q8_0; Command-R-plus style with its per-
head q/k norm ([heads, head_dim] weights), which the JAX forward computes as
an rms norm; a file whose norms carry biases. cohere2 at 4 layers: a
window of 8 on layers 0-2 and layer 3 global without rope; at max_seq 64
the dense engine keeps the ring beside the full store, kv "bf16" the full
store alone and q8_0 the planes, with a 20-token prompt past the window
and decode wrapping the ring. The prefill logits within 1e-4 of max
|logit| and 16 (cohere2: 24) greedy tokens equal, f32 models.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llamacog_tpu.gguf import GGMLType
from llamacog_tpu.models.loader import load_model as jax_load_model
from llamacog_tpu_torch.models.loader import load_model
from llamacog_tpu_torch.runtime.engine import Engine
from llamacog_tpu_torch.runtime.kv_cache import KVCache, QuantKVCache, SwaKVCache
from llamacog_tpu_torch.server.server import ServerContext

from .test_torch_arch_qwen import check_same_run, load_both, write_gguf

WINDOW = 8
MAX_SEQ = 64
PROMPT = [(i * 37) % 250 + 3 for i in range(20)]  # > WINDOW
COMMAND_R = dict(arch="command-r", n_head=4, n_head_kv=4, ffn_norm=False, tied=True,
                 metadata={"command-r.logit_scale": 0.0625,
                           "command-r.attention.layer_norm_epsilon": 1e-5})
CASES = {
    "command-r": dict(COMMAND_R, kind=lambda n: GGMLType.Q8_0),
    "command-r-plus": dict(COMMAND_R, qk_norm="head"),
    "command-r norm biases": dict(COMMAND_R, norm_bias=True),
    "cohere2": dict(arch="cohere2", n_layer=4, n_head=4, n_head_kv=2, ffn_norm=False,
                    tied=True, metadata={"cohere2.logit_scale": 0.25,
                                         "cohere2.attention.sliding_window": WINDOW,
                                         "cohere2.attention.layer_norm_epsilon": 1e-5}),
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("arch_cohere")
    return {name: write_gguf(str(root / f"{name.replace(' ', '_')}.gguf"), **case)
            for name, case in CASES.items()}


@pytest.mark.parametrize("kv_type", ["dense", "q8_0"])
@pytest.mark.parametrize("case", ["command-r", "command-r-plus", "command-r norm biases"])
def test_command_r_tokens_match_jax(files, case, kv_type):
    check_same_run(files[case], kv_type)


@pytest.mark.parametrize("kv_type", ["dense", "bf16", "q8_0"])
def test_cohere2_tokens_match_jax(files, kv_type):
    eng = check_same_run(files["cohere2"], kv_type, PROMPT, 24, MAX_SEQ)
    want = {"dense": SwaKVCache, "bf16": KVCache, "q8_0": QuantKVCache}[kv_type]
    assert type(eng.cache) is want


def test_config_and_keys_follow_the_jax_loader(files):
    """Layer norm (eps from its own key), the parallel residual, the logit
    scale, no ffn_norm; cohere2's window on 3 of 4 layers and no rope on
    the 4th; the norm biases carried in f32 under the JAX loader's keys."""
    cfg = load_model(files["cohere2"], device="cpu", with_tokenizer=False).config
    assert (cfg.norm_type, cfg.parallel_residual, cfg.logit_scale) == ("layer", True, 0.25)
    assert [cfg.is_swa(il) for il in range(4)] == [True, True, True, False]
    assert cfg.n_no_rope_layer_step == 4 and cfg.rope.interleaved
    for case in CASES:
        ref = jax_load_model(files[case], with_tokenizer=False, dtype=jnp.float32)
        got = load_model(files[case], dtype=torch.float32, device="cpu", with_tokenizer=False)
        assert set(got.params) == set(ref.params) and "output" not in got.params
        assert set(got.params["layers"][0]) == set(ref.params["layers"][0]), case
        assert "ffn_norm" not in got.params["layers"][0]
    biased = load_model(files["command-r norm biases"], dtype=torch.float32, device="cpu",
                        with_tokenizer=False).params
    assert biased["output_norm_b"].dtype == torch.float32
    assert {"attn_norm_b", "attn_qkv"} <= set(biased["layers"][0])
    plus = load_model(files["command-r-plus"], device="cpu", with_tokenizer=False).params
    assert tuple(plus["layers"][0]["attn_q_norm"].shape) == (4, 16)


def test_cohere2_ring_matches_the_full_store(files):
    """The ring of the window layers beside the full store of the global
    one, against the full store alone with window masks, in the port: a
    prefill past the window, decode wrapping the ring, a second prefill."""
    m = load_model(files["cohere2"], dtype=torch.float32, device="cpu", with_tokenizer=False)
    ring, full = (Engine(m.params, m.config, batch_size=2, max_seq=MAX_SEQ, kv_type=kv,
                         dtype=torch.float32, device="cpu") for kv in ("dense", "bf16"))
    assert isinstance(ring.cache, SwaKVCache) and ring.cache.full.k.shape[0] == 1
    assert ring.cache.k_swa.shape[:3] == (3, 2, WINDOW + 1)
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


def test_server_serves_cohere2_with_context_shift_off(files):
    """The server runs a ring model with context shift off (the ring has no
    shift, as for Gemma), and a greedy request gets the single-stream
    engine's tokens."""
    m = load_model(files["cohere2"], dtype=torch.float32, device="cpu")
    ctx = ServerContext(m, n_slots=1, ctx_size=MAX_SEQ, dtype=torch.float32, device="cpu")
    assert ctx.engine.ring and not ctx.ctx_shift
    task = ctx.make_task({"prompt": PROMPT, "n_predict": 6, "temperature": 0,
                          "return_tokens": True}, "completion")
    ctx.pending.put(task)
    ctx.start()
    try:
        while True:
            msg = task.out.get(timeout=600)
            assert "error" not in msg, msg
            if msg.get("stop"):
                break
    finally:
        ctx.stop()
    eng = Engine(m.params, m.config, max_seq=MAX_SEQ, dtype=torch.float32, device="cpu")
    assert msg["tokens"] == eng.generate_greedy(PROMPT, 6).tokens


def test_cli_runs_command_r(files, capsys):
    """tools/cli.py -m on a command-r file: greedy text on the CPU."""
    from llamacog_tpu_torch.tools import cli

    assert cli.main(["-m", files["command-r"], "--device", "cpu", "--dtype", "f32",
                     "--greedy", "-n", "8", "-p", "hello"]) == 0
    assert "decode: 8" in capsys.readouterr().err


def test_cohere2_shift_re_ropes_every_layer_as_jax(files):
    """The JAX engine's context shift rotates every layer's keys, cohere2's
    global layer too, whose keys were stored without rope; the port keeps
    that parity over the full store (kv bf16, the store the CLI builds):
    the logits after a shift equal the JAX engine's, and the global layer's
    moved keys are rotated, not only moved."""
    ref, eng, _ = load_both(files["cohere2"], batch_size=1, max_seq=MAX_SEQ, kv_type="bf16")
    ref.prefill(PROMPT)
    eng.prefill(PROMPT)
    before = eng.cache.k[3, 0, 10:20].clone()  # the global layer's keys of positions 10-19
    ref.shift_row(0, 4, 6)
    eng.shift_row(0, 4, 6)
    moved = eng.cache.k[3, 0, 4:14]
    assert not torch.allclose(moved, before, atol=1e-3)
    want = np.asarray(ref.decode_one(np.array([9])))
    got = eng.decode_one(np.array([9]))
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
