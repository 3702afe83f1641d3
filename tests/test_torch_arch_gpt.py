"""The GPT-2 and StarCoder families in the port (gpt2, starcoder,
starcoder2), held against the JAX package.

Tiny random GGUFs (tests/test_torch_arch_qwen.py::write_gguf), 2 layers:
GPT-2 style (learned positions added to the embedding and no rope, one
attn_qkv, biases on every product and norm, an ungated GELU FFN, a tied
head); StarCoder style, multi-query (8 query heads over one kv head: rep 8
here, where StarCoderBase-7B has 32; the plain path takes any rep), its
position table Q8_0 (the JAX quantizer quantizes position_embd.weight, so
the port takes it as wire blocks and decodes the looked-up rows); and
StarCoder2 style (rope, q/k/v apart with their biases: attn_v Q8_0 beside
F32 q and k; GQA 4 over 2). The prefill logits within 1e-4 of max |logit| and 16
greedy tokens equal, f32 models, with the dense and the q8_0 cache; the
bf16 prefill logits within 3e-2 of max |logit|. Also: a context shift of a
model without rope moves its keys unrotated in both packages; an engine
whose max_seq reaches past the position table is refused by name, where
the JAX engine takes it (jnp.take reads NaN past the table); the server
serves a GPT-2 file.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llamacog_tpu.gguf import GGMLType
from llamacog_tpu.models.loader import load_model as jax_load_model
from llamacog_tpu.runtime.engine import Engine as JaxEngine
from llamacog_tpu_torch.models.loader import load_model
from llamacog_tpu_torch.quant.wire import WireTensor
from llamacog_tpu_torch.runtime.engine import Engine
from llamacog_tpu_torch.server.server import ServerContext

from .test_torch_arch_phi2 import bf16_prefill_close
from .test_torch_arch_qwen import (
    PROMPT, TOL, check_same_run, load_both, synthetic_matches_file, write_gguf)

N_POS = 256  # the position table's rows: check_same_run's max_seq
GPT_BIASES = ("attn_qkv", "attn_output", "ffn_up", "ffn_down")


def _pos_q8(name):
    return GGMLType.Q8_0 if name == "position_embd.weight" else None


CASES = {
    "gpt2": dict(arch="gpt2", n_embd=128, n_head=4, n_head_kv=4, n_ff=256, fused_qkv=True,
                 ffn_gate=False, norm_bias=True, tied=True, n_pos=N_POS, biases=GPT_BIASES),
    "starcoder": dict(arch="starcoder", n_embd=128, n_head=8, n_head_kv=1, n_ff=256,
                      fused_qkv=True, ffn_gate=False, norm_bias=True, n_pos=N_POS,
                      biases=GPT_BIASES, kind=_pos_q8),
    "starcoder2": dict(arch="starcoder2", n_embd=256, n_head=4, n_head_kv=2, n_ff=256,
                       qkv_bias=True, ffn_gate=False, norm_bias=True,
                       kind=lambda n: GGMLType.Q8_0 if "attn_v" in n else None,
                       biases=("attn_output", "ffn_up", "ffn_down"),
                       metadata={"starcoder2.rope.freq_base": 1e6}),
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("arch_gpt")
    return {name: write_gguf(str(root / f"{name}.gguf"), **case)
            for name, case in CASES.items()}


@pytest.mark.parametrize("kv_type", ["dense", "q8_0"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_tokens_match_jax(files, case, kv_type):
    check_same_run(files[case], kv_type)


def test_gpt2_bf16_prefill_close_to_jax(files):
    bf16_prefill_close(files["gpt2"])


def test_keys_follow_the_jax_loader(files):
    """The JAX loader's keys: pos_embd (a wire tensor where the file has it
    quantized), no rope factors, no ffn_gate; starcoder2's q/k/v apart with
    their biases (a Q8_0 attn_v: no fused q/k/v, and no attn_qk beside a q
    bias)."""
    for case in CASES:
        ref = jax_load_model(files[case], with_tokenizer=False, dtype=jnp.float32)
        got = load_model(files[case], dtype=torch.float32, device="cpu", with_tokenizer=False)
        assert set(got.params) == set(ref.params), case
        assert set(got.params["layers"][0]) == set(ref.params["layers"][0]), case
        assert got.config.rope.enabled is (case == "starcoder2"), case
    star = load_model(files["starcoder"], device="cpu", with_tokenizer=False).params
    assert isinstance(star["pos_embd"], WireTensor) and star["pos_embd"].kind == "Q8_0"
    gpt2 = load_model(files["gpt2"], device="cpu", with_tokenizer=False).params
    assert gpt2["pos_embd"].shape == (N_POS, 128) and "output" not in gpt2
    two = load_model(files["starcoder2"], device="cpu", with_tokenizer=False).params["layers"][0]
    assert {"attn_q", "attn_k", "attn_v", "attn_q_b", "attn_output_b", "ffn_up_b"} <= set(two)


def test_shift_of_a_model_without_rope(files):
    """The JAX shift runs apply_rope, which returns a model's keys as they
    are when rope is off: a gpt2 shift only moves them (their positions
    stay in the residual stream), and the port does the same: the moved
    keys equal the old ones bit for bit, and the logits after the shift
    equal the JAX engine's."""
    ref, eng, _ = load_both(files["gpt2"], batch_size=1, max_seq=N_POS, kv_type="dense")
    ref.prefill(PROMPT)
    eng.prefill(PROMPT)
    before = eng.cache.k[:, 0, 6:12].clone()
    ref.shift_row(0, 2, 4)
    eng.shift_row(0, 2, 4)
    assert torch.equal(eng.cache.k[:, 0, 2:8], before)
    want = np.asarray(ref.decode_one(np.array([9])))
    got = eng.decode_one(np.array([9]))
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def test_max_seq_past_the_positions_is_refused(files):
    """An engine whose max_seq reaches past the learned position table is
    refused by name; the JAX engine takes it (a deliberate difference: its
    jnp.take reads NaN past the table, a CUDA index would fault). An
    inactive full row of a batch, whose position is one past the table,
    reads the last row (its logits are junk in both packages: NaN in the
    JAX engine's), and the active row's logits equal the JAX engine's."""
    m = load_model(files["gpt2"], dtype=torch.float32, device="cpu", with_tokenizer=False)
    with pytest.raises(ValueError, match="learned positions"):
        Engine(m.params, m.config, max_seq=N_POS + 1, dtype=torch.float32, device="cpu")
    ref = jax_load_model(files["gpt2"], with_tokenizer=False, dtype=jnp.float32)
    JaxEngine(ref.params, ref.config, batch_size=1, max_seq=N_POS + 1, dtype=jnp.float32)
    ref_eng, eng, _ = load_both(files["gpt2"], batch_size=2, max_seq=N_POS)
    full = [(i * 37) % 250 + 3 for i in range(N_POS)]
    for e in (ref_eng, eng):
        e.prefill(full, row=0)
        e.prefill(PROMPT, row=1)
    active = np.array([False, True])
    want = np.asarray(ref_eng.decode_one(np.array([5, 9]), active=active))
    got = eng.decode_one(np.array([5, 9]), active=active)
    assert np.isnan(want[0]).all() and np.isfinite(got[0]).all()
    assert np.abs(got[1] - want[1]).max() <= TOL * np.abs(want[1]).max()


def test_server_serves_gpt2(files):
    """The server over a GPT-2 file: a greedy request gets the single-stream
    engine's tokens; a context past the position table is refused."""
    m = load_model(files["gpt2"], dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="learned positions"):
        ServerContext(m, n_slots=1, ctx_size=2 * N_POS, dtype=torch.float32, device="cpu")
    ctx = ServerContext(m, n_slots=2, ctx_size=N_POS, dtype=torch.float32, device="cpu")
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
    eng = Engine(m.params, m.config, max_seq=N_POS, dtype=torch.float32, device="cpu")
    assert msg["tokens"] == eng.generate_greedy(PROMPT, 6).tokens


@pytest.mark.parametrize("case", sorted(CASES))
def test_synthetic_params_are_a_loaded_file(tmp_path, case):
    """make_synthetic_params at each file's geometry is the Q4_K_M file of
    that geometry loaded: the learned positions (dense, as a converted file
    holds them, of the config's n_ctx_train rows: the file's 512), the
    biases, the tied head of GPT-2."""
    geo = {k: v for k, v in CASES[case].items() if k != "kind"}
    synthetic_matches_file(tmp_path, dict(geo, n_pos=512 if geo.get("n_pos") else 0))
