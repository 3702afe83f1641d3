"""Llama 4 in the port (llama4), held against the JAX package.

Two tiny random GGUFs of 4 layers, so layer 3 is a NoPE layer (no rope, q
scaled by the attention temperature) and layers 0-2 chunked layers with the
L2 q/k norm after the rope: the JAX package's own oracle spec
(tests/test_e2e_oracle.py::ARCH_ORACLE_SPECS["llama4"], written by
make_tiny_arch_gguf: F32 weights, so the dense all-expert MoE, on every 2nd
layer with a shared expert, the others dense), and a file with Q8_0 weights
(tests/test_torch_arch_qwen.py::write_gguf), whose experts take the sparse
wire path. The chunk is 8192 positions in a real file; both configs shrink
it to CHUNK, as tests/test_model_e2e.py's chunked test does, so the 20-token
prompt crosses two chunk boundaries; and the attention temperature's floor
of 8192 positions to TEMP_FLOOR, so the NoPE layer's q scale moves from 1
within the prompt (log(floor((p + 1) / floor) + 1) is 0 below the floor).
The f32 prefill logits within 1e-4 of max |logit| and 16 greedy tokens
equal with the dense and the q8_0 cache; every layer attends through the
masked path (no flash route: the JAX route for a chunked model).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llamacog_tpu.gguf import GGMLType
from llamacog_tpu.models import llama as jax_llama
from llamacog_tpu.models.loader import load_model as jax_load_model
from llamacog_tpu.runtime.engine import Engine as JaxEngine
from llamacog_tpu.utils.testing import make_tiny_arch_gguf
from llamacog_tpu_torch.models import llama
from llamacog_tpu_torch.models.loader import load_model
from llamacog_tpu_torch.ops.cuda import flash_decode, flash_prefill, flash_q8
from llamacog_tpu_torch.runtime.engine import Engine
from llamacog_tpu_torch.runtime.kv_cache import make_cache
from llamacog_tpu_torch.server.server import ServerContext

from .test_torch_arch_qwen import TOL, synthetic_matches_file, write_gguf
from .test_torch_arch_qwen import one_torch_thread  # noqa: F401 (an autouse fixture)

CHUNK = 8
TEMP_FLOOR = 4
MAX_SEQ = 64
N_DECODE = 16
PROMPT = list(range(3, 23))  # 20 tokens: past the chunk boundaries at 8 and 16
# tests/test_e2e_oracle.py::ARCH_ORACLE_SPECS["llama4"]
SPEC = dict(n_layer=4, n_expert=4, n_expert_used=2, n_expert_shared=1, moe_layer_step=2,
            extra_metadata={"llama4.expert_feed_forward_length": 96,
                            "llama4.interleave_moe_layer_step": 2})
# the same layout with Q8_0 weights: the experts take the sparse wire path
WIRE = dict(arch="llama4", n_layer=4, n_expert=4, n_expert_used=2, n_ff_exp=64, shexp_ff=64,
            moe_step=2, kind=lambda n: GGMLType.Q8_0,
            metadata={"llama4.interleave_moe_layer_step": 2})


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("arch_llama4")
    return {"spec": make_tiny_arch_gguf(str(root / "spec.gguf"), "llama4", seed=5, **SPEC),
            "wire": write_gguf(str(root / "wire.gguf"), **WIRE)}


def shrink(cfg):
    cfg.sliding_window, cfg.n_attn_temp_floor_scale = CHUNK, TEMP_FLOOR
    return cfg


def load_pair(path):
    """(JAX model, port model) of the file as f32 models, both configs'
    chunk and temperature floor shrunk."""
    ref = jax_load_model(path, with_tokenizer=False, dtype=jnp.float32)
    got = load_model(path, dtype=torch.float32, device="cpu", with_tokenizer=False)
    shrink(ref.config), shrink(got.config)
    return ref, got


# one JAX engine per (file, cache kind) for the module, reset before each
# use: its jitted steps compile once
_JAX_ENGINES = {}


def engines(path, kv_type="dense"):
    """(empty JAX engine, port engine) of the file, f32, the chunk and the
    temperature floor shrunk."""
    if (path, kv_type) not in _JAX_ENGINES:
        ref = jax_load_model(path, with_tokenizer=False, dtype=jnp.float32)
        _JAX_ENGINES[path, kv_type] = JaxEngine(ref.params, shrink(ref.config), batch_size=1,
                                                max_seq=MAX_SEQ, dtype=jnp.float32,
                                                kv_type=kv_type)
    jeng = _JAX_ENGINES[path, kv_type]
    jeng.reset()
    got = load_model(path, dtype=torch.float32, device="cpu", with_tokenizer=False)
    return jeng, Engine(got.params, shrink(got.config), batch_size=1, max_seq=MAX_SEQ,
                        dtype=torch.float32, kv_type=kv_type, device="cpu")


@pytest.mark.parametrize("case,kv_type", [("spec", "dense"), ("spec", "q8_0"),
                                          ("wire", "dense")])
def test_llama4_tokens_match_jax(files, case, kv_type):
    jeng, eng = engines(files[case], kv_type)
    cfg = eng.config
    assert cfg.swa_type == "chunked" and cfg.use_kq_norm
    assert cfg.use_attn_temp and cfg.moe_weight_before
    want = np.asarray(jeng.prefill(PROMPT))
    out = eng.prefill(PROMPT)
    assert float(np.abs(out - want).max()) <= TOL * float(np.abs(want).max())
    first = np.array([int(np.argmax(want))])
    np.testing.assert_array_equal(eng.decode_greedy_tokens(first, N_DECODE),
                                  np.asarray(jeng.decode_greedy_tokens(first, N_DECODE)))


def one_shot_logits(m, tokens):
    """The logits of every position of `tokens` from one forward over an
    empty cache."""
    cfg = m.config
    cache = make_cache("dense", cfg.n_layer, 1, MAX_SEQ, cfg.n_head_kv, cfg.head_dim_k,
                       cfg.head_dim_v, dtype=torch.float32, device="cpu")
    toks = torch.tensor([tokens])
    logits, _ = llama.forward(m.params, cfg, toks, torch.arange(len(tokens))[None], cache,
                              torch.zeros(1, dtype=torch.int32), dtype=torch.float32)
    return logits[0].numpy()


def test_decode_after_a_partial_prefill_matches_one_shot_prefill(files):
    """tests/test_model_e2e.py's chunked test on the port: decode steps past
    a 6-token prefill cross the chunk boundaries at 8 and 16 and match the
    one-shot prefill within 2e-4; the chunks change the result (against the
    same model with the standard sliding window)."""
    _, m = load_pair(files["spec"])
    full = one_shot_logits(m, PROMPT)
    eng = Engine(m.params, m.config, batch_size=1, max_seq=MAX_SEQ, dtype=torch.float32,
                 device="cpu")
    eng.prefill(PROMPT[:6])
    for i, t in enumerate(PROMPT[6:18]):
        np.testing.assert_allclose(eng.decode_one(np.array([t]))[0], full[6 + i], atol=2e-4)
    m.config.swa_type = "standard"
    sliding = one_shot_logits(m, PROMPT)
    assert np.abs(sliding[12:] - full[12:]).max() > 1e-5


def test_no_flash_route_for_a_chunked_model(files, monkeypatch):
    """Every layer of a chunked model attends through the masked path, at
    prefill and decode, over the dense and the q8_0 cache: the route
    predicates refuse it, and no flash wrapper is called."""
    _, m = load_pair(files["spec"])
    calls = []
    for mod, name in ((flash_q8, "decode_from_cache"), (flash_q8, "flash_decode_q8_auto"),
                      (flash_q8, "flash_prefill_q8"), (flash_prefill, "flash_prefill_attention"),
                      (flash_decode, "flash_decode_attention")):
        monkeypatch.setattr(mod, name, lambda *a, _n=name, **k: calls.append(_n))
    monkeypatch.setenv("LLAMACOG_FLASH_DECODE", "1")
    for kv_type in ("dense", "q8_0"):
        eng = Engine(m.params, m.config, batch_size=1, max_seq=MAX_SEQ, dtype=torch.float32,
                     kv_type=kv_type, device="cpu")
        eng.decode_greedy_tokens(np.array([int(np.argmax(eng.prefill(PROMPT)))]), 3)
        cache = eng.cache
        assert not flash_q8.stacked_decode_supported(m.config, cache, 1)
        assert not flash_q8.decode_supported(m.config, cache, 1)
        assert not flash_q8.prefill_supported(m.config, cache)
        assert not flash_decode.supported(m.config, cache, 1)
    assert calls == []


@pytest.mark.parametrize("case,rows", [("spec", 3), ("wire", 3), ("wire", 17)])
def test_moe_weights_before_the_experts_match_jax(files, case, rows):
    """The MoE FFN with llama4's gate weights on the expert input (the
    outputs summed unweighted), the sigmoid router and the ungated shared
    expert, against the JAX _ffn_moe on the same input: the dense
    all-expert einsums (F32 file) and the sparse wire path, by the
    expert-gathered matvec (3 rows: 6 pairs) and the grouped GEMM over
    sorted rows (17 rows: 34 pairs, past _MOE_GATHER_MAX)."""
    ref, got = load_pair(files[case])
    il = 1  # the first MoE layer (moe_layer_step 2)
    assert "ffn_gate_inp" in got.params["layers"][il]
    assert "ffn_gate_inp" not in got.params["layers"][0]
    x = np.random.default_rng(rows).standard_normal((1, rows, 64)).astype(np.float32)
    want = np.asarray(jax_llama._ffn_moe(ref.params["layers"][il], jnp.asarray(x), ref.config))
    out = llama._ffn_moe(got.params["layers"][il], torch.from_numpy(x), got.config).numpy()
    assert np.abs(out - want).max() <= 1e-5 * np.abs(want).max()


def test_context_shift_rotates_the_nope_layers_keys_as_jax(files):
    """Fault 3.14: the JAX context shift re-ropes every layer's keys, the
    NoPE layer's too, which were stored without rope, and the chunked
    layers' L2-normed keys (the rotation keeps their norm); the port keeps
    parity: the logits after a shift equal the JAX engine's, and the NoPE
    layer's moved keys are rotated, not only moved."""
    jeng, eng = engines(files["spec"])
    jeng.prefill(PROMPT)
    eng.prefill(PROMPT)
    before = eng.cache.k[3, 0, 10:20].clone()  # the NoPE layer's keys of positions 10-19
    jeng.shift_row(0, 4, 6)
    eng.shift_row(0, 4, 6)
    assert not torch.allclose(eng.cache.k[3, 0, 4:14], before, atol=1e-3)
    want = np.asarray(jeng.decode_one(np.array([9])))
    out = eng.decode_one(np.array([9]))
    assert np.abs(out - want).max() <= TOL * np.abs(want).max()


def test_cli_runs_llama4(files, capsys):
    """tools/cli.py -m on a llama4 file: greedy text on the CPU."""
    from llamacog_tpu_torch.tools import cli

    assert cli.main(["-m", files["wire"], "--device", "cpu", "--dtype", "f32", "--greedy",
                     "-n", "8", "-p", "hello"]) == 0
    assert "decode: 8" in capsys.readouterr().err


def test_server_serves_llama4_on_two_slots(files):
    """The server over a llama4 file with 2 slots: two greedy requests at
    once, each the single-stream engine's tokens (the chunk at its real 8192
    positions: no row crosses one)."""
    m = load_model(files["wire"], dtype=torch.float32, device="cpu")
    ctx = ServerContext(m, n_slots=2, ctx_size=MAX_SEQ, dtype=torch.float32, device="cpu")
    prompts = (PROMPT[:12], PROMPT[5:])
    tasks = [ctx.make_task({"prompt": p, "n_predict": 6, "temperature": 0,
                            "return_tokens": True}, "completion") for p in prompts]
    for task in tasks:
        ctx.pending.put(task)
    ctx.start()
    finals = []
    try:
        for task in tasks:
            while True:
                msg = task.out.get(timeout=600)
                assert "error" not in msg, msg
                if msg.get("stop"):
                    finals.append(msg)
                    break
    finally:
        ctx.stop()
    eng = Engine(m.params, m.config, max_seq=MAX_SEQ, dtype=torch.float32, device="cpu")
    for p, msg in zip(prompts, finals):
        eng.reset()
        assert msg["tokens"] == eng.generate_greedy(p, 6).tokens


def test_synthetic_params_are_a_loaded_file(tmp_path):
    """make_synthetic_params at the wire file's geometry is its Q4_K_M file
    loaded: the shared expert of n_ff_exp rows (a llama4 GGUF has no
    expert_shared_count), the dense layers between the MoE ones."""
    geo = {k: v for k, v in WIRE.items() if k != "kind"}
    synthetic_matches_file(tmp_path, dict(geo, n_embd=256, n_ff=256, n_ff_exp=256,
                                          shexp_ff=256))
