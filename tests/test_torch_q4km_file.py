"""A Q4_K_M file of an 8-expert model, as llama.cpp's type rules write it,
loaded by both packages (the port's Q8_0 and Q5_K wire kinds).

The JAX package's quantizer (llamacog_tpu/tools/quantize.py, its copy of
llama_tensor_get_type) gives an 8-expert model Q8_0 attn_k and attn_v and,
under Q4_K_M, Q5_K attn_output; attn_q stays Q4_K, so the loaders keep the
three attention weights apart. A tiny random F32 GGUF written by the JAX
package's writer is quantized so, then loaded by both packages: the same
keys, every tensor dequantized bit for bit alike, and the same f32 greedy
tokens (tolerances as tests/test_torch_moe.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llamacog_tpu.gguf import GGMLType
from llamacog_tpu.models.loader import load_model as jax_load_model
from llamacog_tpu.quant.planar import QuantTensor, decode
from llamacog_tpu.runtime.engine import Engine as JaxEngine
from llamacog_tpu.tools.quantize import quantize_model
from llamacog_tpu.utils.testing import make_tiny_llama_gguf
from llamacog_tpu_torch.convert import from_reference, gguf_tensors
from llamacog_tpu_torch.gguf import GGUFModelReader
from llamacog_tpu_torch.models.config import ModelConfig
from llamacog_tpu_torch.models.loader import load_model
from llamacog_tpu_torch.quant import wire
from llamacog_tpu_torch.runtime.engine import Engine

PROMPT = [(i * 37) % 250 + 3 for i in range(20)]
N_DECODE = 8
# tensor -> the kind llama.cpp's Q4_K_M rules give it in an 8-expert model
FILE_KINDS = {"attn_q": "Q4_K", "attn_k": "Q8_0", "attn_v": "Q8_0", "attn_output": "Q5_K"}


@pytest.fixture(scope="module")
def q4km_8x(tmp_path_factory):
    d = tmp_path_factory.mktemp("q4km")
    src = make_tiny_llama_gguf(str(d / "f32.gguf"), n_embd=256, n_ff=256, n_layer=2, n_head=4,
                               n_head_kv=2, n_expert=8, n_expert_used=2,
                               extra_metadata={"llama.expert_weights_norm": True})
    out = str(d / "q4_k_m.gguf")
    quantize_model(src, out, "Q4_K_M")
    return out


def test_file_has_the_8_expert_q4km_kinds(q4km_8x):
    reader = GGUFModelReader(q4km_8x)
    try:
        for il in range(2):
            for key, kind in FILE_KINDS.items():
                ti = reader.tensor_info(f"blk.{il}.{key}.weight")
                assert GGMLType(ti.ggml_type).name == kind
    finally:
        reader.close()


def test_from_reference_matches_jax_loader(q4km_8x):
    """attn_q, attn_k and attn_v stay apart in both trees (mixed kinds);
    every tensor dequantizes bit for bit to the JAX tensor's planar.decode."""
    ref = jax_load_model(q4km_8x, with_tokenizer=False, dtype=jnp.float32).params
    reader = GGUFModelReader(q4km_8x)
    cfg = ModelConfig.from_metadata(reader.metadata)
    got = from_reference(cfg, gguf_tensors(reader), device="cpu", dtype=torch.float32)
    reader.close()
    assert set(got) == set(ref)
    for lg, lr in zip(got["layers"], ref["layers"]):
        assert set(lg) == set(lr)
        assert {"attn_q", "attn_k", "attn_v"} <= set(lg) and "attn_qk" not in lg
        for key, kind in FILE_KINDS.items():
            assert lg[key].kind == kind
        for key in lg:
            assert isinstance(lg[key], wire.WireTensor) == isinstance(lr[key], QuantTensor)
            a = wire.dequantize(lg[key]) if isinstance(lg[key], wire.WireTensor) else lg[key]
            b = decode(lr[key], jnp.float32) if isinstance(lr[key], QuantTensor) else lr[key]
            np.testing.assert_array_equal(a.numpy().reshape(-1), np.asarray(b).reshape(-1))


def _run(path, port: bool):
    if port:
        m = load_model(path, dtype=torch.float32, device="cpu", with_tokenizer=False)
        eng = Engine(m.params, m.config, batch_size=1, max_seq=512, dtype=torch.float32,
                     device="cpu")
    else:
        m = jax_load_model(path, with_tokenizer=False, dtype=jnp.float32)
        eng = JaxEngine(m.params, m.config, batch_size=1, max_seq=512, dtype=jnp.float32)
    logits = np.asarray(eng.prefill(PROMPT))
    toks = eng.decode_greedy_tokens(np.array([int(np.argmax(logits))]), N_DECODE)
    return logits, np.asarray(toks)


def test_engine_greedy_tokens_match_jax(q4km_8x):
    ref_logits, ref_toks = _run(q4km_8x, port=False)
    logits, toks = _run(q4km_8x, port=True)
    assert int(np.argmax(logits)) == int(np.argmax(ref_logits))
    np.testing.assert_allclose(logits, ref_logits, atol=2e-3, rtol=1e-3)
    assert toks.shape == (1, N_DECODE)
    np.testing.assert_array_equal(toks, ref_toks)


def test_synthetic_file_kinds_match_the_file(q4km_8x):
    """make_synthetic_params on an 8-expert config, the layout of the card's
    Mixtral runs, has the loaded file's keys, kinds and shapes for every
    wire tensor but the router (kept f32 there, as llama.cpp keeps
    ffn_gate_inp)."""
    from llamacog_tpu_torch.utils.synthetic import make_synthetic_params

    m = load_model(q4km_8x, dtype=torch.float32, device="cpu", with_tokenizer=False)
    syn = make_synthetic_params(m.config, seed=0, device="cpu")
    for lf, ls in zip(m.params["layers"], syn["layers"]):
        assert set(lf) == set(ls)
        for key, w in lf.items():
            if isinstance(w, wire.WireTensor) and key != "ffn_gate_inp":
                assert (ls[key].kind, ls[key].shape) == (w.kind, w.shape), key
