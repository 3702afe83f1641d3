"""The port's slice as a whole against the JAX package on a tiny Q4_K_M llama.

Both packages load the same GGUF (an F32 tiny llama quantized with the
repo's own Q4_K_M tool, so attn_qk fuses and attn_v is Q6_K) and run at
max_seq=512, so the JAX side goes through its Pallas prefill (K5, or K7
with a quantized cache) and stacked decode (K4, or K6) kernels in interpret
mode, and the port through the plain versions of its kernels (CPU tensors).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llamacog_tpu.gguf import GGMLType
from llamacog_tpu.models.loader import load_model as jax_load_model
from llamacog_tpu.quant.planar import QuantTensor, decode
from llamacog_tpu.runtime.engine import Engine as JaxEngine
from llamacog_tpu.tools.quantize import main as quantize_main
from llamacog_tpu.utils.testing import make_tiny_llama_gguf
from llamacog_tpu_torch.convert import from_reference, gguf_tensors, kv_cache_from_reference
from llamacog_tpu_torch.gguf import GGUFModelReader
from llamacog_tpu_torch.models.loader import load_model
from llamacog_tpu_torch.quant.wire import WireTensor, dequantize
from llamacog_tpu_torch.runtime.engine import Engine
from llamacog_tpu_torch.runtime.kv_cache import QuantKVCache

PROMPT = [3, 17, 9, 41, 200, 5, 77]
N_DECODE = 8


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's torch ops on one thread: its models are a few hundred
    wide, so more threads buy nothing, and under the test runner's parallel
    workers they contend for the cores (the previous count is restored)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def q4km_path(tmp_path_factory):
    d = tmp_path_factory.mktemp("q4km")
    src = str(d / "f32.gguf")
    make_tiny_llama_gguf(src, n_embd=256, n_head=4, n_head_kv=2, n_ff=512,
                         quant_type=GGMLType.F32)
    q = str(d / "q4km.gguf")
    assert quantize_main([src, q, "Q4_K_M"]) == 0
    return q


def _run_jax(path, dtype, kv_type="dense"):
    m = jax_load_model(path, with_tokenizer=False, dtype=dtype)
    eng = JaxEngine(m.params, m.config, batch_size=1, max_seq=512, dtype=dtype,
                    kv_type=kv_type)
    logits = np.asarray(eng.prefill(PROMPT))
    toks = eng.decode_greedy_tokens(np.array([int(np.argmax(logits))]), N_DECODE)
    return logits, np.asarray(toks)


def _run_port(path, dtype, kv_type="dense"):
    m = load_model(path, dtype=dtype, device="cpu", with_tokenizer=False)
    eng = Engine(m.params, m.config, batch_size=1, max_seq=512, dtype=dtype, kv_type=kv_type,
                 device="cpu")
    logits = eng.prefill(PROMPT)
    toks = eng.decode_greedy_tokens(np.array([int(np.argmax(logits))]), N_DECODE)
    return logits, toks


def test_f32_prefill_logits_and_greedy_tokens_match_jax(q4km_path):
    ref_logits, ref_toks = _run_jax(q4km_path, jnp.float32)
    logits, toks = _run_port(q4km_path, torch.float32)
    assert logits.dtype == np.float32 and logits.shape == ref_logits.shape
    np.testing.assert_allclose(logits, ref_logits, atol=2e-3, rtol=1e-3)
    assert toks.shape == (1, N_DECODE)
    np.testing.assert_array_equal(toks, ref_toks)


@pytest.mark.parametrize("kv_type", ["q8_0", "q4_0", "q5_0:q4_1", "bf16:q4_0"])
def test_f32_quant_kv_greedy_tokens_match_jax(q4km_path, kv_type):
    """The quantized cache path (plain K7 at prefill, K6 at decode) gives the
    JAX engine's greedy tokens exactly; the prefill logits (a fresh prompt
    attends no cached token) as closely as the dense path's. q4_0's tokens
    differ from the dense cache's, so this tells a quantized path from one
    that attends dense K/V."""
    ref_logits, ref_toks = _run_jax(q4km_path, jnp.float32, kv_type)
    logits, toks = _run_port(q4km_path, torch.float32, kv_type)
    np.testing.assert_allclose(logits, ref_logits, atol=2e-3, rtol=1e-3)
    assert toks.shape == (1, N_DECODE)
    np.testing.assert_array_equal(toks, ref_toks)
    if kv_type == "q4_0":
        _, dense_toks = _run_port(q4km_path, torch.float32)
        assert not np.array_equal(toks, dense_toks)


def test_bf16_q8_0_kv_close_to_jax(q4km_path):
    """As the dense bf16 test, through the q8_0 cache: prefill logits of a
    second chunk (which attends the quantized first chunk) within a few
    bf16 ulps of the largest logit."""
    out = []
    for engine, dtype, dev in ((JaxEngine, jnp.bfloat16, None), (Engine, torch.bfloat16, "cpu")):
        if dev is None:
            m = jax_load_model(q4km_path, with_tokenizer=False, dtype=dtype)
            eng = engine(m.params, m.config, batch_size=1, max_seq=512, dtype=dtype,
                         kv_type="q8_0")
        else:
            m = load_model(q4km_path, dtype=dtype, device=dev, with_tokenizer=False)
            eng = engine(m.params, m.config, batch_size=1, max_seq=512, dtype=dtype,
                         kv_type="q8_0", device=dev)
        eng.prefill(PROMPT)
        out.append(np.asarray(eng.prefill(PROMPT[::-1]), np.float32))
    ref_logits, logits = out
    assert np.isfinite(logits).all()
    assert np.abs(logits - ref_logits).max() / np.abs(ref_logits).max() < 3e-2


def test_quant_kv_state_carried_from_jax(q4km_path):
    """The JAX engine prefills into a q5_1:q4_0 cache; kv_cache_from_reference
    carries that cache into the port; one decode_one in each package then
    gives the same logits."""
    mj = jax_load_model(q4km_path, with_tokenizer=False, dtype=jnp.float32)
    je = JaxEngine(mj.params, mj.config, batch_size=1, max_seq=512, dtype=jnp.float32,
                   kv_type="q5_1:q4_0")
    je.prefill(PROMPT)
    m = load_model(q4km_path, dtype=torch.float32, device="cpu", with_tokenizer=False)
    eng = Engine(m.params, m.config, batch_size=1, max_seq=512, dtype=torch.float32,
                 kv_type="q5_1:q4_0", device="cpu")
    c = je.cache
    eng.cache = kv_cache_from_reference([np.asarray(p) for p in c.k_planes],
                                        [np.asarray(p) for p in c.v_planes], c.kinds, c.hkv,
                                        device="cpu")
    assert isinstance(eng.cache, QuantKVCache) and eng.cache.kinds == ("q5_1", "q4_0")
    eng.seq_len[:] = je.seq_len
    want = np.asarray(je.decode_one(np.array([42])))
    got = eng.decode_one([42])
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-3)


def test_bf16_prefill_logits_close_to_jax(q4km_path):
    """bf16 rounds at the same cast points in both packages, but the JAX
    CPU path multiplies bf16-rounded weights where the port's B <= 8 plain
    path (like the TPU matvec kernel) keeps f32 weights, and the two
    frameworks' bf16 accumulations differ in order: the bound is a few
    bf16 ulps of the largest logit."""
    ref_logits, _ = _run_jax(q4km_path, jnp.bfloat16)
    logits, toks = _run_port(q4km_path, torch.bfloat16)
    assert np.isfinite(logits).all() and toks.shape == (1, N_DECODE)
    err = np.abs(logits - ref_logits).max() / np.abs(ref_logits).max()
    assert err < 3e-2


def test_from_reference_matches_jax_loader(q4km_path):
    """Same key sets as the JAX loader's tree; every port tensor
    dequantizes to the JAX tensor's planar.decode (bit-exact)."""
    ref = jax_load_model(q4km_path, with_tokenizer=False, dtype=jnp.float32).params
    reader = GGUFModelReader(q4km_path)
    from llamacog_tpu_torch.models.config import ModelConfig

    cfg = ModelConfig.from_metadata(reader.metadata)
    got = from_reference(cfg, gguf_tensors(reader), device="cpu", dtype=torch.float32)
    reader.close()

    def as_np(v):
        if isinstance(v, WireTensor):
            return dequantize(v).numpy()
        return v.float().numpy()

    def ref_np(v):
        return np.asarray(decode(v, jnp.float32) if isinstance(v, QuantTensor) else v,
                          np.float32)

    assert set(got) == set(ref)
    assert any("attn_qk" in layer for layer in got["layers"])
    assert len(got["layers"]) == len(ref["layers"])
    for key in got:
        if key != "layers":
            np.testing.assert_array_equal(as_np(got[key]), ref_np(ref[key]))
    for lg, lr in zip(got["layers"], ref["layers"]):
        assert set(lg) == set(lr)
        for key in lg:
            assert isinstance(lg[key], WireTensor) == isinstance(lr[key], QuantTensor)
            np.testing.assert_array_equal(as_np(lg[key]), ref_np(lr[key]))


def test_engine_raises_on_unported_options(q4km_path):
    """An architecture the port does not carry raises; batch_size > 1 is
    ported (tests/test_torch_engine_batch.py), a batch of none is refused."""
    import dataclasses

    m = load_model(q4km_path, dtype=torch.float32, device="cpu", with_tokenizer=False)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        Engine(m.params, dataclasses.replace(m.config, arch="mamba"), device="cpu")
    assert Engine(m.params, m.config, batch_size=2, device="cpu").batch_size == 2
    with pytest.raises(ValueError, match="batch_size"):
        Engine(m.params, m.config, batch_size=0, device="cpu")
    with pytest.raises(ValueError, match="unknown kv cache type"):
        Engine(m.params, m.config, kv_type="q9_0", device="cpu")


def test_cli_greedy_generation_on_cpu(tmp_path, capsys):
    from llamacog_tpu_torch.tools.cli import main

    path = make_tiny_llama_gguf(str(tmp_path / "tiny.gguf"))
    assert main(["-m", path, "-p", "hello", "-n", "4", "--device", "cpu",
                 "--dtype", "f32", "-c", "64"]) == 0
    out = capsys.readouterr()
    assert out.out.startswith("hello") and "[perf]" in out.err


def test_cli_quantized_kv_cache_on_cpu(tmp_path, capsys):
    from llamacog_tpu_torch.tools.cli import _kv_type_arg, main

    assert _kv_type_arg("q8_0", None) == "q8_0"
    assert _kv_type_arg("q8_0", "q4_0") == "q8_0:q4_0"
    path = make_tiny_llama_gguf(str(tmp_path / "tiny.gguf"))
    assert main(["-m", path, "-p", "hello", "-n", "4", "--device", "cpu", "--dtype", "f32",
                 "-c", "64", "-ctk", "q8_0", "-ctv", "q4_0"]) == 0
    out = capsys.readouterr()
    assert out.out.startswith("hello") and "[perf]" in out.err
