"""The port's slice as a whole against the JAX package on a tiny Q4_K_M llama.

Both packages load the same GGUF (an F32 tiny llama quantized with the
repo's own Q4_K_M tool, so attn_qk fuses and attn_v is Q6_K) and run at
max_seq=512, so the JAX side goes through its Pallas prefill (K5) and
stacked decode (K4) kernels in interpret mode, and the port through the
plain versions of its kernels (CPU tensors).
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
from llamacog_tpu_torch.convert import from_reference, gguf_tensors
from llamacog_tpu_torch.gguf import GGUFModelReader
from llamacog_tpu_torch.models.loader import load_model
from llamacog_tpu_torch.quant.wire import WireTensor, dequantize
from llamacog_tpu_torch.runtime.engine import Engine

PROMPT = [3, 17, 9, 41, 200, 5, 77]
N_DECODE = 8


@pytest.fixture(scope="module")
def q4km_path(tmp_path_factory):
    d = tmp_path_factory.mktemp("q4km")
    src = str(d / "f32.gguf")
    make_tiny_llama_gguf(src, n_embd=256, n_head=4, n_head_kv=2, n_ff=512,
                         quant_type=GGMLType.F32)
    q = str(d / "q4km.gguf")
    assert quantize_main([src, q, "Q4_K_M"]) == 0
    return q


def _run_jax(path, dtype):
    m = jax_load_model(path, with_tokenizer=False, dtype=dtype)
    eng = JaxEngine(m.params, m.config, batch_size=1, max_seq=512, dtype=dtype)
    logits = np.asarray(eng.prefill(PROMPT))
    toks = eng.decode_greedy_tokens(np.array([int(np.argmax(logits))]), N_DECODE)
    return logits, np.asarray(toks)


def _run_port(path, dtype):
    m = load_model(path, dtype=dtype, device="cpu", with_tokenizer=False)
    eng = Engine(m.params, m.config, batch_size=1, max_seq=512, dtype=dtype, device="cpu")
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
    m = load_model(q4km_path, dtype=torch.float32, device="cpu", with_tokenizer=False)
    with pytest.raises(NotImplementedError):
        Engine(m.params, m.config, batch_size=2, device="cpu")
    with pytest.raises(NotImplementedError):
        Engine(m.params, m.config, kv_type="q8_0", device="cpu")


def test_cli_greedy_generation_on_cpu(tmp_path, capsys):
    from llamacog_tpu_torch.tools.cli import main

    path = make_tiny_llama_gguf(str(tmp_path / "tiny.gguf"))
    assert main(["-m", path, "-p", "hello", "-n", "4", "--device", "cpu",
                 "--dtype", "f32", "-c", "64"]) == 0
    out = capsys.readouterr()
    assert out.out.startswith("hello") and "[perf]" in out.err
