"""llama.cpp's weight presets other than Q4_K_M on a dense llama model,
loaded by both packages (the port's legacy and low-bit wire kinds).

A tiny random F32 GGUF (n_embd 256, n_ff 256, 2 layers, 4 query heads over
1 kv head: Llama-3-8B's grouping, which llama.cpp's attn_v rules read) is
quantized by the JAX package's quantizer (llamacog_tpu/tools/quantize.py,
its copy of llama_tensor_get_type) to each preset. For each file: its
tensor kinds are utils/synthetic.py's table for the preset, and
make_synthetic_params gives the loaded file's keys, kinds and shapes (the
layout of the synthetic runs on the card); both packages load it to the
same keys and every tensor dequantizes bit for bit alike; the f32 greedy
tokens are the JAX package's (tolerances as tests/test_torch_moe.py).
tests/test_torch_presets_moe.py does the same for an 8-expert model.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llamacog_tpu.gguf import GGMLType
from llamacog_tpu.models.loader import load_model as jax_load_model
from llamacog_tpu.quant.planar import QuantTensor, decode
from llamacog_tpu.runtime.engine import Engine as JaxEngine
from llamacog_tpu.tools.quantize import (FTYPE_BASE, FTYPE_NAMES, QuantizeState, quantize_model,
                                         tensor_get_type)
from llamacog_tpu.utils.testing import make_tiny_llama_gguf
from llamacog_tpu_torch.convert import from_reference, gguf_tensors
from llamacog_tpu_torch.gguf import GGUFModelReader
from llamacog_tpu_torch.models.config import ModelConfig
from llamacog_tpu_torch.models.loader import load_model
from llamacog_tpu_torch.quant import wire
from llamacog_tpu_torch.runtime.engine import Engine
from llamacog_tpu_torch.utils import synthetic
from llamacog_tpu_torch.utils.synthetic import make_synthetic_params, tensor_kinds

PRESETS = ["Q4_0", "Q4_1", "Q5_0", "Q5_1", "Q2_K", "Q3_K_M", "Q5_K_M", "Q8_0"]
PROMPT = [(i * 37) % 250 + 3 for i in range(20)]
N_DECODE = 8
# GGUF tensor name -> the key of utils/synthetic.py's table
_TABLE_KEY = {"attn_q": "attn_q", "attn_k": "attn_k", "attn_v": "attn_v",
              "attn_output": "attn_output", "ffn_gate": "ffn_gate", "ffn_up": "ffn_up",
              "ffn_down": "ffn_down", "ffn_gate_exps": "ffn_gate", "ffn_up_exps": "ffn_up",
              "ffn_down_exps": "ffn_down"}


class PresetFiles:
    """One tiny F32 GGUF and its quantized copies, made on first use; with
    `imatrix`, the path of an importance matrix (the .dat layout
    tools/quantize.py::load_imatrix reads) the quantizer takes."""

    def __init__(self, root, n_layer: int = 2, **model):
        self.root = root
        self.src = make_tiny_llama_gguf(str(root / "f32.gguf"), n_embd=256, n_ff=256,
                                        n_layer=n_layer, **model)
        self.paths = {}

    def __call__(self, preset: str, imatrix: str | None = None) -> str:
        key = (preset, imatrix)
        if key not in self.paths:
            out = str(self.root / f"{preset}{'-imatrix' if imatrix else ''}.gguf")
            quantize_model(self.src, out, preset, imatrix_path=imatrix)
            self.paths[key] = out
        return self.paths[key]


def check_kinds(path: str, preset: str, imatrix: bool = False) -> None:
    """The file's kinds are the table's (the router aside: the JAX
    quantizer quantizes ffn_gate_inp, llama.cpp never does and the
    synthetic params keep it f32), and make_synthetic_params has the loaded
    file's keys, kinds and shapes."""
    reader = GGUFModelReader(path)
    try:
        cfg = ModelConfig.from_metadata(reader.metadata)
        table = tensor_kinds(cfg, preset, imatrix)
        for name, key in (("token_embd", "token_embd"), ("output", "output")):
            got = GGMLType(reader.tensor_info(f"{name}.weight").ggml_type).name
            assert got == table[key], (preset, name)
        for il in range(cfg.n_layer):
            for name, key in _TABLE_KEY.items():
                full = f"blk.{il}.{name}.weight"
                if full in reader.tensors:
                    got = GGMLType(reader.tensor_info(full).ggml_type).name
                    assert got == table["layers"][il][key], (preset, full)
    finally:
        reader.close()
    m = load_model(path, dtype=torch.float32, device="cpu", with_tokenizer=False)
    syn = make_synthetic_params(m.config, seed=0, device="cpu", ftype=preset, imatrix=imatrix)
    for key in ("tok_embd", "output"):
        assert (syn[key].kind, syn[key].shape) == (m.params[key].kind, m.params[key].shape)
    for lf, ls in zip(m.params["layers"], syn["layers"]):
        assert set(lf) == set(ls), preset
        for key, w in lf.items():
            if isinstance(w, wire.WireTensor) and key != "ffn_gate_inp":
                assert (ls[key].kind, ls[key].shape) == (w.kind, w.shape), (preset, key)


def check_same_tensors(path: str) -> None:
    """Both loaders give the same keys (the same fusions) and every tensor
    dequantizes bit for bit to the JAX tensor's planar.decode."""
    ref = jax_load_model(path, with_tokenizer=False, dtype=jnp.float32).params
    reader = GGUFModelReader(path)
    cfg = ModelConfig.from_metadata(reader.metadata)
    got = from_reference(cfg, gguf_tensors(reader), device="cpu", dtype=torch.float32)
    reader.close()
    assert set(got) == set(ref)
    for lg, lr in zip(got["layers"], ref["layers"]):
        assert set(lg) == set(lr)
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


def check_greedy_tokens(path: str) -> None:
    ref_logits, ref_toks = _run(path, port=False)
    logits, toks = _run(path, port=True)
    assert int(np.argmax(logits)) == int(np.argmax(ref_logits))
    np.testing.assert_allclose(logits, ref_logits, atol=2e-3, rtol=1e-3)
    assert toks.shape == (1, N_DECODE)
    np.testing.assert_array_equal(toks, ref_toks)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return PresetFiles(tmp_path_factory.mktemp("presets_dense"), n_head=4, n_head_kv=1)


@pytest.mark.parametrize("preset", PRESETS)
def test_file_kinds_are_the_synthetic_table(files, preset):
    check_kinds(files(preset), preset)


@pytest.mark.parametrize("preset", PRESETS)
def test_both_loaders_give_the_same_tensors(files, preset):
    check_same_tensors(files(preset))


@pytest.mark.parametrize("preset", PRESETS)
def test_engine_greedy_tokens_match_jax(files, preset):
    check_greedy_tokens(files(preset))


def check_tensor_kinds_at(cfgs, preset: str, imatrix: bool) -> None:
    """tensor_kinds against the JAX quantizer's tensor_get_type for each
    config, tensor by tensor in GGUF order."""
    for cfg in cfgs:
        ftype = FTYPE_NAMES[preset]
        qs = QuantizeState(n_layer=cfg.n_layer, n_gqa=cfg.n_head // cfg.n_head_kv,
                           n_expert=cfg.n_expert, has_output=True, has_imatrix=imatrix)

        def jax_kind(name, k):
            return GGMLType(tensor_get_type(qs, FTYPE_BASE[ftype], name, (k,), ftype)).name

        table = tensor_kinds(cfg, preset, imatrix)
        assert jax_kind("token_embd.weight", cfg.n_embd) == table["token_embd"]
        assert jax_kind("output.weight", cfg.n_embd) == table["output"]
        exps = "_exps" if cfg.n_expert else ""
        for il, kinds in enumerate(table["layers"]):
            for key in ("attn_q", "attn_k", "attn_v", "attn_output", "ffn_gate", "ffn_up",
                        "ffn_down"):
                suffix = key + (exps if key.startswith("ffn") else "")
                got = jax_kind(f"blk.{il}.{suffix}.weight", cfg.n_ff if key == "ffn_down"
                               else cfg.n_embd)
                assert got == kinds[key], (preset, imatrix, cfg.n_expert, il, key)


@pytest.mark.parametrize("preset", sorted(synthetic.PRESETS))
def test_tensor_kinds_follow_the_jax_quantizer_at_full_depth(preset):
    """The table at the card's configurations (Llama-3-8B and Mixtral-8x7B,
    32 layers), without an importance matrix."""
    check_tensor_kinds_at((synthetic.llama3_8b_config(), synthetic.mixtral_8x7b_config()),
                          preset, imatrix=False)


def test_default_layout_is_q4_k_m_with_every_dense_attn_v_q6_k():
    """The synthetic default keeps the layout of the earlier measurements:
    Q4_K_M's table, but Q6_K attn_v in every layer of a dense config (so
    attn_q + attn_k fuse and attn_v stays apart); a MoE config's is Q4_K_M's."""
    dense, moe = synthetic.llama3_8b_config(), synthetic.mixtral_8x7b_config()
    for cfg in (dense, moe):
        want = tensor_kinds(cfg, "Q4_K_M")
        if not cfg.n_expert:
            assert {lk["attn_v"] for lk in want["layers"]} == {"Q4_K", "Q6_K"}
            for lk in want["layers"]:
                lk["attn_v"] = "Q6_K"
        assert synthetic.layout_kinds(cfg) == want
