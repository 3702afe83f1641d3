"""32-weight-block tensors whose rows are not a multiple of 256 in the port
(Q4_0, Q4_1, Q5_0, Q5_1, Q8_0, IQ4_NL at K = 96, 160, ...), held against
the JAX package.

llama.cpp gives such kinds to rows a K-quant cannot split (Qwen2.5-0.5B's
n_embd of 896, Gemma-3-1B's 1152, an expert FFN of 1408). The port pads
each row with zero blocks to a whole 256-weight run at carry time
(quant/wire.py): the plain dequant trims the pad and is bit-exact against
decode_np, qmatmul matches the JAX package's, and a 2-layer llama GGUF of
n_embd 96 (every kind in it, a MoE one too) gives the JAX package's f32
greedy tokens (tests/test_torch_kernels_k32.py holds the kernels on such
rows against the plain path, on the card). utils/synthetic.py's fallback
kinds follow llama.cpp's rule, which the JAX quantizer does not copy
(ROADMAP §3.11); the CLI runs the synthetic Qwen2.5-0.5B by name.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llamacog_tpu.gguf import GGMLType
from llamacog_tpu.ops.linear import qmatmul as jax_qmatmul
from llamacog_tpu.quant import dequantize_tensor, quantize_tensor
from llamacog_tpu.quant.planar import from_gguf
from llamacog_tpu.tools.quantize import FTYPE_BASE, FTYPE_NAMES, QuantizeState, tensor_get_type
from llamacog_tpu_torch.ops.linear import qmatmul
from llamacog_tpu_torch.quant import wire
from llamacog_tpu_torch.utils import synthetic

from .test_torch_arch_qwen import check_same_run, write_gguf

KINDS = ["Q4_0", "Q4_1", "Q5_0", "Q5_1", "Q8_0", "IQ4_NL"]


def _tensor(kind: str, n: int, k: int, seed: int):
    arr = np.random.default_rng(seed).standard_normal((n, k)).astype(np.float32)
    return quantize_tensor(arr, GGMLType[kind])


@pytest.mark.parametrize("k", [96, 160])
@pytest.mark.parametrize("kind", KINDS)
def test_padded_rows_dequant_and_qmatmul_match_jax(kind, k):
    n = 64
    raw = _tensor(kind, n, k, seed=k)
    w = wire.from_bytes(raw, GGMLType[kind], (n, k))
    assert w.k_pad == 256 and tuple(w.blocks.shape) == (n, wire.BLOCK_BYTES[kind])
    want = dequantize_tensor(raw, GGMLType[kind], (n, k))
    np.testing.assert_array_equal(wire.dequantize(w).numpy(), want)
    rows = torch.tensor([3, 0, 63, 3])
    np.testing.assert_array_equal(wire.dequantize_rows(w, rows).numpy(), want[rows.numpy()])
    x = np.random.default_rng(1).standard_normal((3, k)).astype(np.float32)
    ref = np.asarray(jax_qmatmul(jnp.asarray(x), from_gguf(raw, GGMLType[kind], (n, k))))
    got = qmatmul(torch.from_numpy(x), w).numpy()
    assert float(np.abs(got - ref).max()) <= 1e-6 * float(np.abs(ref).max())


def test_padded_expert_stack_dequant():
    """A stack [n_exp, N, K] pads each expert's rows alike; the selected
    experts decode to decode_np's values."""
    raw = _tensor("Q5_0", 4 * 32, 160, seed=5)
    w = wire.from_bytes(raw, GGMLType.Q5_0, (4, 32, 160))
    want = dequantize_tensor(raw, GGMLType.Q5_0, (4, 32, 160))
    got = wire.dequantize_experts(w, torch.tensor([2, 0]))
    np.testing.assert_array_equal(got.numpy(), want[[2, 0]])


def test_wire_refuses_other_row_lengths():
    with pytest.raises(ValueError, match="multiple of 256"):
        wire.WireTensor("Q4_K", (4, 96), torch.zeros((4, 144), dtype=torch.uint8))
    with pytest.raises(ValueError, match="multiple of 32"):
        wire.WireTensor("Q8_0", (4, 100), torch.zeros((4, 272), dtype=torch.uint8))


def _llama_kinds(name: str):
    """Every 32-block kind in one model: token_embd Q4_0, attn_q/attn_k
    Q5_0, attn_v Q8_0, attn_output Q4_1, gate/up IQ4_NL, down (K 160) Q5_1,
    the head Q8_0."""
    for part, kind in (("token_embd", "Q4_0"), ("attn_q", "Q5_0"), ("attn_k", "Q5_0"),
                       ("attn_v", "Q8_0"), ("attn_output", "Q4_1"), ("ffn_gate", "IQ4_NL"),
                       ("ffn_up", "IQ4_NL"), ("ffn_down", "Q5_1"), ("output", "Q8_0")):
        if part in name:
            return GGMLType[kind]
    return None


@pytest.mark.parametrize("moe", [False, True])
def test_llama_of_width_96_matches_jax(tmp_path, moe):
    """A 2-layer llama GGUF with n_embd 96 (head dim 48) and n_ff 160: the
    f32 prefill logits and 16 greedy tokens are the JAX package's; the MoE
    file (4 experts, top 2) pads its expert stacks too."""
    extra = dict(n_expert=4, n_expert_used=2, n_ff_exp=160) if moe else {}
    path = write_gguf(str(tmp_path / "k96.gguf"), "llama", n_embd=96, n_head=2, n_head_kv=1,
                      n_ff=160, kind=_llama_kinds, **extra)
    eng = check_same_run(path)
    layer = eng.params["layers"][0]
    w = layer["ffn_down_exps" if moe else "ffn_down"]
    assert (w.kind, w.shape[-1], w.k_pad) == ("Q5_1", 160, 256)


def test_fallback_kinds_follow_llama_cpp():
    """Qwen2.5-0.5B at Q4_K_M (n_embd 896 = 3.5 runs of 256): llama.cpp's
    convert_incompatible_tensor gives Q4_K rows Q5_0 and Q6_K rows Q8_0,
    and the tied embedding the head's Q8_0; rows of 4864 keep their
    K-quants. The JAX quantizer takes the first 32-block kind of its list
    (Q4_0) for every such row instead (ROADMAP §3.11)."""
    cfg = synthetic.qwen2_5_0_5b_config()
    kinds = synthetic.tensor_kinds(cfg, "Q4_K_M")
    assert kinds["token_embd"] == "Q8_0"
    for il, lk in enumerate(kinds["layers"]):
        more = synthetic._use_more_bits(il, cfg.n_layer)
        assert (lk["attn_q"], lk["attn_k"], lk["attn_output"], lk["ffn_gate"]) == ("Q5_0",) * 4
        assert lk["attn_v"] == ("Q8_0" if more else "Q5_0")
        assert lk["ffn_down"] == ("Q6_K" if more else "Q4_K")
    for preset, want in (("Q5_K_M", "Q5_1"), ("Q3_K_M", "IQ4_NL"), ("IQ4_XS", "IQ4_NL"),
                         ("TQ1_0", "Q4_0"), ("Q8_0", "Q8_0")):
        assert synthetic.tensor_kinds(cfg, preset)["layers"][1]["ffn_gate"] == want, preset
    qs = QuantizeState(n_layer=cfg.n_layer, n_gqa=7, n_expert=0, has_output=False,
                       has_imatrix=False)
    ftype = FTYPE_NAMES["Q4_K_M"]
    jax_kind = tensor_get_type(qs, FTYPE_BASE[ftype], "blk.0.attn_q.weight", (896,), ftype)
    assert GGMLType(jax_kind).name == "Q4_0"


def test_synthetic_padded_weights_run():
    """Qwen2.5-0.5B's widths (vocab cut to 512, 2 layers): the synthetic
    params hold padded Q5_0/Q8_0 weights with zero pad blocks, and the
    forward runs on them."""
    cfg = dataclasses.replace(synthetic.qwen2_5_0_5b_config(n_layer=2), n_vocab=512)
    params = synthetic.make_synthetic_params(cfg, device="cpu", ftype="Q4_K_M")
    w = params["layers"][0]["attn_qkv"]
    assert (w.kind, w.shape, w.k_pad) == ("Q5_0", (1152, 896), 1024)
    assert not bool(w.blocks.reshape(1152, 4, -1)[:, 3, 22 * 4:].any())  # the pad blocks
    assert "output" not in params and params["tok_embd"].kind == "Q8_0"
    from llamacog_tpu_torch.runtime.engine import Engine
    eng = Engine(params, cfg, max_seq=64, dtype=torch.float32, device="cpu")
    logits = eng.prefill([1, 2, 3, 4, 5])
    assert logits.shape == (512,) and np.isfinite(logits).all()


def test_cli_runs_a_synthetic_model_by_name(capsys, monkeypatch):
    """tools/cli.py -m synthetic:NAME: Qwen2.5-0.5B (cut to 1 layer here)
    on the CPU, with its padded Q5_0/Q8_0 weights and a synthetic vocab of
    its size."""
    from llamacog_tpu_torch.tools import cli

    monkeypatch.setitem(synthetic.CONFIGS, "qwen2.5-0.5b",
                        lambda: synthetic.qwen2_5_0_5b_config(n_layer=1))
    assert cli.main(["-m", "synthetic:qwen2.5-0.5b", "--device", "cpu",
                     "-n", "2", "--greedy", "-p", "hi"]) == 0
    assert "[perf] prompt:" in capsys.readouterr().err
    with pytest.raises(SystemExit, match="unknown synthetic model"):
        cli.main(["-m", "synthetic:gpt-5", "--device", "cpu"])
