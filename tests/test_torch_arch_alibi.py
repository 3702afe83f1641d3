"""The ALiBi families in the port (bloom, mpt, refact, jais), held against
the JAX package.

Tiny random GGUFs, 2 layers: refact and jais by the JAX package's own
oracle specs (tests/test_e2e_oracle.py::ARCH_ORACLE_SPECS, written by
make_tiny_arch_gguf: refact the llama block without rope; jais layer
norms, one biased attn_qkv, a biased SwiGLU and the 1/d attention scale);
the others by tests/test_torch_arch_qwen.py::write_gguf: BLOOM style (the
embedding's layer norm, token_embd_norm, biases on every product and norm,
an ungated GELU FFN, a tied head; also at 6 heads, whose slopes take both
branches of ggml's rule), MPT style (no bias anywhere, clamp_kqv low
enough to clip, and a file with q/k norm tensors of the head's width),
Refact-1.6B's multi-query heads (8 over one), and Jais with an FFN of 200
(its ffn_down rows of 200 weights, which 32 does not divide, F16 as
llama.cpp leaves them, beside Q8_0 products). The f32 prefill logits
within 1e-4 of max |logit| and 16 greedy tokens equal, with the dense cache
and, for BLOOM, the q8_0 cache. Every layer attends through the masked
path with each head's slope times the distance added: no flash route (the
JAX route for an ALiBi model).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llamacog_tpu.gguf import GGMLType
from llamacog_tpu.models import llama as jax_llama
from llamacog_tpu.models.loader import load_model as jax_load_model
from llamacog_tpu.ops.attention import masked_attention as jax_masked_attention
from llamacog_tpu.utils.testing import make_tiny_arch_gguf
from llamacog_tpu_torch.models import llama
from llamacog_tpu_torch.models.loader import load_model
from llamacog_tpu_torch.ops import attention
from llamacog_tpu_torch.ops.cuda import build, flash_decode, flash_prefill, flash_q8
from llamacog_tpu_torch.runtime.engine import Engine
from llamacog_tpu_torch.server.server import ServerContext
from llamacog_tpu_torch.utils import synthetic

from .test_torch_arch_qwen import (
    PROMPT, TOL, check_same_run, load_both, synthetic_matches_file, write_gguf)
from .test_torch_arch_qwen import one_torch_thread  # noqa: F401 (an autouse fixture)

GPT_BIASES = ("attn_qkv", "attn_output", "ffn_up", "ffn_down")
CLAMP = 0.25  # below the tiny MPT's largest q/k/v activations: the clamp binds


def _embd_norm(n_embd, seed=3):
    rng = np.random.default_rng(seed)
    return {"token_embd_norm.weight": 1.0 + 0.1 * rng.standard_normal(n_embd),
            "token_embd_norm.bias": 0.1 * rng.standard_normal(n_embd)}


def _jais_kinds(name):
    """Q8_0 products, and the ffn_down of 200-weight rows F16."""
    if "ffn_down" in name:
        return GGMLType.F16
    return GGMLType.Q8_0 if name.endswith("weight") and "norm" not in name else None


BLOOM = dict(arch="bloom", n_embd=128, n_head=4, n_head_kv=4, n_ff=256, fused_qkv=True,
             ffn_gate=False, norm_bias=True, tied=True, biases=GPT_BIASES,
             extra_tensors=_embd_norm(128))
CASES = {
    "bloom": BLOOM,
    # 6 heads: n2 = 4, so heads 4 and 5 take the slopes' second branch
    "bloom 6 heads": dict(BLOOM, n_embd=192, n_head=6, n_head_kv=6,
                          extra_tensors=_embd_norm(192)),
    "mpt": dict(arch="mpt", n_embd=128, n_head=4, n_head_kv=4, n_ff=256, fused_qkv=True,
                ffn_gate=False, tied=True, metadata={"mpt.attention.max_alibi_bias": 8.0}),
    # q/k/v apart with q/k norms of the head's width, and the clamp
    "mpt clamp qk-norm": dict(arch="mpt", n_embd=128, n_head=4, n_head_kv=4, n_ff=256,
                              ffn_gate=False, tied=True, qk_norm=True,
                              metadata={"mpt.attention.clamp_kqv": CLAMP}),
    # Refact-1.6B's multi-query heads: 8 over one kv head
    "refact mqa": dict(arch="refact", n_embd=128, n_head=8, n_head_kv=1, n_ff=256),
    "jais f16": dict(arch="jais", n_embd=128, n_head=4, n_head_kv=4, n_ff=200, fused_qkv=True,
                     norm_bias=True, biases=(*GPT_BIASES, "ffn_gate"), tied=True,
                     kind=_jais_kinds),
}
# tests/test_e2e_oracle.py::ARCH_ORACLE_SPECS
SPECS = {"refact": dict(),
         "jais": dict(norm="layer", norm_bias=True, qkv="fused", qkv_bias=True, o_bias=True,
                      ffn_bias=True, n_head_kv=4,
                      extra_metadata={"jais.attention.max_alibi_bias": 8.0})}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("arch_alibi")
    out = {name: write_gguf(str(root / f"{name.replace(' ', '_')}.gguf"), **case)
           for name, case in CASES.items()}
    for arch, spec in SPECS.items():
        out[arch] = make_tiny_arch_gguf(str(root / f"{arch}.gguf"), arch, seed=17, **spec)
    return out


@pytest.mark.parametrize("case,kv_type", [
    ("bloom", "dense"), ("bloom", "q8_0"), ("bloom 6 heads", "dense"), ("mpt", "dense"),
    ("mpt clamp qk-norm", "dense"), ("refact", "dense"), ("refact mqa", "dense"),
    ("jais", "dense"), ("jais f16", "dense")])
def test_alibi_tokens_match_jax(files, case, kv_type):
    check_same_run(files[case], kv_type)


@pytest.mark.parametrize("n_head", [1, 4, 6, 8, 12, 32, 40, 71])
def test_slopes_match_jax(n_head):
    """ggml's two branches, bit for bit: Jais-13B's 40 heads past 32, and
    the 6 heads of the test file past 4."""
    for max_bias in (8.0, 4.0):
        want = np.asarray(jax_llama._alibi_slopes(n_head, max_bias))
        got = attention.alibi_slopes(n_head, max_bias, "cpu").numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("H,Hkv", [(6, 6), (6, 2), (8, 1)])
def test_masked_attention_with_alibi_matches_jax(H, Hkv):
    """The masked attention with slopes, against the JAX masked_attention
    on the JAX _build_masks' ALiBi masks: a 5-token block over a 16-slot
    cache at write offsets 7 and 0, with a softcap (the bias joins after
    it), heads mapped h = kv_head * rep + r."""
    from llamacog_tpu.models.config import ModelConfig as JaxConfig

    B, T, S, D = 2, 5, 16, 32
    rng = np.random.default_rng(H * 10 + Hkv)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, T, H, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    kc, vc = (rng.standard_normal((B, T, Hkv, D)).astype(np.float32) for _ in range(2))
    wp = np.array([7, 0], np.int32)
    jcfg = JaxConfig(arch="bloom", n_vocab=8, n_ctx_train=S, n_embd=H * D, n_layer=1,
                     n_head=H, n_head_kv=Hkv, n_ff=8, head_dim_k=D, head_dim_v=D,
                     use_alibi=True)
    (mask, intra), _ = jax_llama._build_masks(jcfg, jnp.asarray(wp), T, S)
    want = np.asarray(jax_masked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask, D ** -0.5, logit_softcap=20.0,
        k_cur=jnp.asarray(kc), v_cur=jnp.asarray(vc), intra_mask=intra,
        alibi_slopes=jax_llama._alibi_slopes(H, 8.0)))
    wpt = torch.from_numpy(wp)
    alibi = (attention.alibi_slopes(H, 8.0, "cpu"), *attention.alibi_distances(wpt, T, S))
    got = attention.masked_attention(
        *(torch.from_numpy(a) for a in (q, k, v, kc, vc)), attention.old_cache_mask(wpt, T, S),
        attention.intra_block_mask(T), D ** -0.5, logit_softcap=20.0, alibi=alibi).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=1e-5)
    # the bias moves the result (so the test holds it)
    free = attention.masked_attention(
        *(torch.from_numpy(a) for a in (q, k, v, kc, vc)), attention.old_cache_mask(wpt, T, S),
        attention.intra_block_mask(T), D ** -0.5, logit_softcap=20.0).numpy()
    assert np.abs(free - want).max() > 1e-2


def test_two_chunk_prefill_matches_jax_and_one_shot(files):
    """A prompt prefilled in two chunks (7 then 5 tokens): the second
    chunk's distances run over the first's slots, so its last logits equal
    the JAX engine's two-chunk prefill and the port's one-shot prefill;
    the greedy tokens after it equal the JAX engine's."""
    ref, eng, _ = load_both(files["bloom"], batch_size=1, max_seq=256, kv_type="dense")
    ref.prefill(PROMPT[:7])
    eng.prefill(PROMPT[:7])
    want = np.asarray(ref.prefill(PROMPT[7:]))
    got = eng.prefill(PROMPT[7:])
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= TOL * scale
    eng.reset()
    assert np.abs(eng.prefill(PROMPT) - got).max() <= TOL * scale
    eng.reset()
    eng.prefill(PROMPT[:7])
    eng.prefill(PROMPT[7:])
    first = np.array([int(np.argmax(want))])
    np.testing.assert_array_equal(eng.decode_greedy_tokens(first, 16),
                                  np.asarray(ref.decode_greedy_tokens(first, 16)))


def test_no_flash_route_for_an_alibi_model(files, monkeypatch):
    """Every layer of an ALiBi model attends through the masked path, at
    prefill and decode, over the dense and the q8_0 cache, by the stacked
    and the per-layer decode routes alike: the route predicates refuse it
    and no flash wrapper is called (each raises here)."""
    m = load_model(files["bloom"], dtype=torch.float32, device="cpu", with_tokenizer=False)

    def refuse(*a, **k):
        raise AssertionError("a flash route ran for an ALiBi model")

    for mod, name in ((flash_q8, "decode_from_cache"), (flash_q8, "flash_decode_q8_auto"),
                      (flash_q8, "flash_prefill_q8"), (flash_prefill, "flash_prefill_attention"),
                      (flash_decode, "flash_decode_attention")):
        monkeypatch.setattr(mod, name, refuse)
    monkeypatch.setenv("LLAMACOG_FLASH_DECODE", "1")
    for stacked in ("1", "0"):
        monkeypatch.setenv("LLAMACOG_FLASH_STACKED", stacked)
        for kv_type in ("dense", "q8_0"):
            eng = Engine(m.params, m.config, batch_size=1, max_seq=64, dtype=torch.float32,
                         kv_type=kv_type, device="cpu")
            eng.decode_greedy_tokens(np.array([int(np.argmax(eng.prefill(PROMPT)))]), 3)
            cache = eng.cache
            assert flash_q8.masked_only(m.config)
            assert not flash_q8.stacked_decode_supported(m.config, cache, 1)
            assert not flash_q8.decode_supported(m.config, cache, 1)
            assert not flash_q8.prefill_supported(m.config, cache)
            assert not flash_prefill.supported(m.config, cache)
            assert not flash_decode.supported(m.config, cache, 1)
    assert build.LAUNCHES.get("flash_prefill", 0) == 0


def test_decode_step_logits_equal_an_eager_forward(files):
    """The decode step (DecodeStep: the distances built from its write
    offset buffer, the slopes made once on the device, the logits copied
    into its static buffer; on the card this body is what the graph
    captures) gives the logits of the same forward called eagerly at the
    same state, bit for bit, step after step."""
    m = load_model(files["bloom"], dtype=torch.float32, device="cpu", with_tokenizer=False)
    engs = [Engine(m.params, m.config, batch_size=1, max_seq=64, dtype=torch.float32,
                   device="cpu") for _ in range(2)]
    for e in engs:
        e.prefill(PROMPT)
    step, eager = engs
    tok = 5
    for _ in range(4):
        n = int(eager.seq_len[0])
        want = eager._step(torch.tensor([[tok]]), eager._dev_i32([n]), 1,
                           kv_cap=eager._kv_cap(n + 1))[0, 0]
        eager.seq_len[0] += 1
        got = step.decode_one([tok])[0]
        assert torch.equal(torch.from_numpy(got), want)
        tok = int(want.argmax())


def test_context_shift_moves_the_keys_unrotated_as_jax(files):
    """Fault 3.15: an ALiBi model has no rope, so the JAX shift
    (apply_rope, which returns the keys when rope is off) only moves the
    kept keys down; the distances then run over the new slots. The port
    keeps parity: the moved keys equal the old ones bit for bit, and the
    logits after the shift equal the JAX engine's."""
    ref, eng, _ = load_both(files["bloom"], batch_size=1, max_seq=256, kv_type="dense")
    ref.prefill(PROMPT)
    eng.prefill(PROMPT)
    before = eng.cache.k[:, 0, 6:12].clone()
    ref.shift_row(0, 2, 4)
    eng.shift_row(0, 2, 4)
    assert torch.equal(eng.cache.k[:, 0, 2:8], before)
    want = np.asarray(ref.decode_one(np.array([9])))
    got = eng.decode_one(np.array([9]))
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def test_keys_and_config_follow_the_jax_loader(files):
    """The JAX loader's keys: bloom's tok_norm and tok_norm_b (f32, as every
    norm), the fused attn_qkv and its bias; jais's biased gate apart from
    up (no gate_up fusion past a gate bias) and its F16 ffn_down a dense
    weight; the ALiBi configs: no rope, the max bias, jais's 1/d scale."""
    for case in ("bloom", "mpt", "mpt clamp qk-norm", "refact", "jais", "jais f16"):
        ref = jax_load_model(files[case], with_tokenizer=False, dtype=jnp.float32)
        got = load_model(files[case], dtype=torch.bfloat16, device="cpu", with_tokenizer=False)
        assert set(got.params) == set(ref.params), case
        assert set(got.params["layers"][0]) == set(ref.params["layers"][0]), case
        for f in ("use_alibi", "max_alibi_bias", "kq_scale", "norm_type", "attn_clamp"):
            assert getattr(got.config, f) == getattr(ref.config, f), (case, f)
        assert got.config.use_alibi and not got.config.rope.enabled
    bloom = load_model(files["bloom"], dtype=torch.bfloat16, device="cpu", with_tokenizer=False)
    assert bloom.params["tok_norm"].dtype == bloom.params["tok_norm_b"].dtype == torch.float32
    jais = load_model(files["jais f16"], dtype=torch.bfloat16, device="cpu",
                      with_tokenizer=False).params["layers"][0]
    assert {"ffn_gate", "ffn_gate_b", "ffn_up", "ffn_up_b"} <= set(jais)
    assert isinstance(jais["ffn_down"], torch.Tensor) and jais["ffn_down"].shape == (128, 200)
    assert load_model(files["jais"], device="cpu", with_tokenizer=False).config.kq_scale == 1 / 16  # 1 / d at d = 16


def test_the_clamp_binds(files):
    """The MPT file's clamp changes the logits (so the token test holds the
    clamp), against the same model without it."""
    m = load_model(files["mpt clamp qk-norm"], dtype=torch.float32, device="cpu",
                   with_tokenizer=False)
    clamped = Engine(m.params, m.config, max_seq=64, dtype=torch.float32,
                     device="cpu").prefill(PROMPT)
    m.config.attn_clamp = 0.0
    free = Engine(m.params, m.config, max_seq=64, dtype=torch.float32,
                  device="cpu").prefill(PROMPT)
    assert np.abs(clamped - free).max() > 1e-3 * np.abs(free).max()


def test_mpt_layer_norms_of_q_and_k_as_jax(tmp_path):
    """Fault 3.15: llama.cpp's MPT q/k norms (qk_ln) are layer norms over the
    whole projection, n_embd wide with biases; the JAX forward runs any
    attn_q_norm as a per-head rms norm (llama.py:676-678) and cannot
    broadcast such a weight over the heads, and the port refuses the file
    by name (attn_q_norm.bias). Norms of the head's width run per head in
    both (the "mpt clamp qk-norm" case of test_alibi_tokens_match_jax)."""
    from llamacog_tpu.runtime.engine import Engine as JaxEngine

    path = write_gguf(str(tmp_path / "mpt_qk_ln.gguf"), **dict(
        CASES["mpt"], qk_norm="full", norm_bias=True))
    ref = jax_load_model(path, with_tokenizer=False, dtype=jnp.float32)
    assert ref.params["layers"][0]["attn_q_norm"].shape == (128,)
    with pytest.raises(ValueError, match="broadcast"):
        JaxEngine(ref.params, ref.config, batch_size=1, max_seq=64,
                  dtype=jnp.float32).prefill(PROMPT)
    with pytest.raises(NotImplementedError, match="attn_q_norm.bias"):
        load_model(path, device="cpu", with_tokenizer=False)


def test_server_serves_bloom(files):
    """The server over a BLOOM file: two greedy requests on two slots, each
    the single-stream engine's tokens."""
    m = load_model(files["bloom"], dtype=torch.float32, device="cpu")
    ctx = ServerContext(m, n_slots=2, ctx_size=64, dtype=torch.float32, device="cpu")
    prompts = (PROMPT, PROMPT[3:])
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
    eng = Engine(m.params, m.config, max_seq=64, dtype=torch.float32, device="cpu")
    for p, msg in zip(prompts, finals):
        eng.reset()
        assert msg["tokens"] == eng.generate_greedy(p, 6).tokens


def test_cli_runs_bloom(files, capsys):
    """tools/cli.py -m on a BLOOM file: greedy text on the CPU."""
    from llamacog_tpu_torch.tools import cli

    assert cli.main(["-m", files["bloom"], "--device", "cpu", "--dtype", "f32", "--greedy",
                     "-n", "8", "-p", "hello"]) == 0
    assert "decode: 8" in capsys.readouterr().err


@pytest.mark.parametrize("case", ["bloom", "mpt", "refact mqa", "jais f16"])
def test_synthetic_params_are_a_loaded_file(tmp_path, case):
    """make_synthetic_params at each file's geometry is its Q4_K_M file
    loaded: bloom's embedding norm, biases and tied head, mpt's bare
    products, refact's q/k/v apart, jais's biased gate apart from up."""
    geo = {k: v for k, v in CASES[case].items() if k != "kind"}
    synthetic_matches_file(tmp_path, dict(geo, n_embd=256, n_ff=512,
                                          extra_tensors=_embd_norm(256) if case == "bloom"
                                          else None))


def test_synthetic_jais_down_of_200_is_a_dense_weight(tmp_path):
    """At an FFN of 200 (Jais-13B's 13653 in small: 32 divides neither)
    tensor_kinds gives ffn_down F16, as llama.cpp leaves it, and the
    synthetic model holds it as the loaded file does: a dense [E, 200]
    weight (bf16, the model dtype of the runs on the card)."""
    geo = {k: v for k, v in CASES["jais f16"].items() if k != "kind"}
    path = write_gguf(str(tmp_path / "f32.gguf"), **dict(geo, n_embd=256))
    cfg = load_model(path, device="cpu", with_tokenizer=False).config
    cfg.tie_word_embeddings = True
    assert synthetic.tensor_kinds(cfg, "Q4_K_M")["layers"][0]["ffn_down"] == "F16"
    down = synthetic.make_synthetic_params(cfg, device="cpu", ftype="Q4_K_M")["layers"][0][
        "ffn_down"]
    got = load_model(write_gguf(str(tmp_path / "f16.gguf"), **dict(geo, n_embd=256),
                                kind=lambda n: GGMLType.F16 if "ffn_down" in n else None),
                     dtype=torch.bfloat16, device="cpu", with_tokenizer=False)
    want = got.params["layers"][0]["ffn_down"]
    assert (down.dtype, tuple(down.shape)) == (want.dtype, tuple(want.shape)) == (
        torch.bfloat16, (256, 200))


def test_the_four_synthetic_configs_are_admitted():
    """check_supported admits BLOOM-7B1, MPT-7B, Jais-13B and Refact-1.6B at
    their published widths; ALiBi stays refused outside the four."""
    for name in ("bloom-7b1", "mpt-7b", "jais-13b", "refact-1.6b"):
        cfg = synthetic.CONFIGS[name](n_layer=2)
        llama.check_supported(cfg)
        assert cfg.use_alibi and flash_q8.masked_only(cfg)
    assert synthetic.jais_13b_config().n_ff % 32 != 0
    assert synthetic.tensor_kinds(synthetic.jais_13b_config(n_layer=2),
                                  "Q4_K_M")["layers"][0]["ffn_down"] == "F16"
