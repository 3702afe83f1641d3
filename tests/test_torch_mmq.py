"""The port's int8 prefill path (LLAMACOG_MMQ=1: quant/mmq.py, K13 in
ops/cuda/qmm_i8.py, the dispatch in ops/linear.py) against the JAX package.

The planes and the activation quantization must be bit-equal to the JAX
package's as its engine runs them (jitted: XLA turns `/ 127.0` into a
product with f32(1/127), and the port forms scales so). The plain K13 is
held against the Pallas kernel in interpret mode within 1e-6 of the largest
|output|: the integer block products are exact in both, but XLA contracts
the CPU combine into FMAs (fma(p_0, ws_0, p_1 * ws_1)), one rounding per
block that the port's combine (and its CUDA kernel) does not take.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llamacog_tpu.gguf import GGMLType
from llamacog_tpu.ops.pallas.qmm_i8 import qmm_i8 as jax_qmm_i8
from llamacog_tpu.quant import quantize
from llamacog_tpu.quant.mmq import build_mmq_planes as jax_build_mmq_planes
from llamacog_tpu.quant.planar import from_gguf
from llamacog_tpu.utils.synthetic import _rand_qt
from llamacog_tpu_torch.ops import linear
from llamacog_tpu_torch.ops.cuda.qmm import qmm_plain
from llamacog_tpu_torch.ops.cuda.qmm_i8 import qmm_i8, qmm_i8_plain, quantize_activations
from llamacog_tpu_torch.quant import mmq, wire
from llamacog_tpu_torch.utils.synthetic import random_experts, random_wire

REPO = Path(__file__).resolve().parents[1]
K13_TOL = 1e-6  # of the largest |output|: one FMA rounding per 512-column block


def _pair(kind, n, k, seed):
    """The same GGUF blocks as a JAX planar QuantTensor and a port WireTensor."""
    t = getattr(GGMLType, kind)
    rng = np.random.default_rng(seed)
    raw = quantize(rng.standard_normal((n, k)).astype(np.float32).reshape(-1), t)
    qt = from_gguf(raw, t, (n, k))
    qt.planes = {name: jnp.asarray(v) for name, v in qt.planes.items()}
    return qt, wire.from_bytes(raw, t, (n, k))


def _with_planes(kind, n, k, seed):
    qt, w = _pair(kind, n, k, seed)
    qt.planes.update(jax_build_mmq_planes(qt))
    qi8, ws8T = mmq.build_mmq_planes(w)
    return qt, wire.WireTensor(w.kind, w.shape, w.blocks, qi8, ws8T)


def rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("kind", ["Q4_K", "Q6_K", "Q8_0", "Q5_K"])
def test_mmq_planes_bit_equal_to_jax(kind):
    qt, w = _pair(kind, 512, 1024, seed=1)
    ref = jax_build_mmq_planes(qt)
    qi8, ws8T = mmq.build_mmq_planes(w)
    assert qi8.dtype == torch.int8 and ws8T.dtype == torch.float32
    np.testing.assert_array_equal(qi8.numpy(), np.asarray(ref["qi8"]))
    np.testing.assert_array_equal(ws8T.numpy(), np.asarray(ref["ws8T"]))


@pytest.mark.parametrize("n,k", [(512, 1024), (256, 512), (384, 512), (512, 768),
                                 (32768, 512), (32512, 512)])
def test_eligibility_filter_matches_jax(n, k):
    """2-D, K a multiple of 512, 256 <= N < 32768, N a multiple of 256."""
    g = torch.Generator().manual_seed(n + k)
    w = random_wire("Q4_K", n, k, g)
    want = jax_build_mmq_planes(_rand_qt(jax.random.PRNGKey(0), "Q4_K", n, k)) is not None
    assert mmq.eligible(w) == want
    assert (mmq.build_mmq_planes(w) is not None) == want
    assert not mmq.eligible(random_experts("Q4_K", 2, 256, 512, g))


def test_attach_returns_new_params_and_leaves_the_callers():
    g = torch.Generator().manual_seed(0)
    layer = {"attn_qk": random_wire("Q4_K", 768, 512, g), "attn_v": random_wire("Q6_K", 128, 512, g),
             "ffn_gate_up_exps": random_experts("Q4_K", 2, 512, 512, g),
             "attn_norm": torch.ones(512)}
    params = {"tok_embd": random_wire("Q4_K", 512, 512, g),
              "output": random_wire("Q6_K", 512, 512, g), "output_norm": torch.ones(512),
              "layers": [layer]}
    before = {k: id(v) for k, v in layer.items()}
    out = mmq.attach_mmq_planes(params)
    assert out is not params and out["layers"] is not params["layers"]
    assert out["layers"][0] is not layer
    assert {k: id(v) for k, v in layer.items()} == before
    assert all(getattr(v, "qi8", None) is None for v in (*layer.values(), params["tok_embd"],
                                                         params["output"]))
    got = out["layers"][0]
    assert got["attn_qk"].qi8.shape == (768, 512) and got["attn_qk"].ws8T.shape == (1, 768)
    assert got["attn_qk"].blocks is layer["attn_qk"].blocks
    # too few rows, a 3-D stack, dense tensors and the embedding / LM head: as they were
    for key in ("attn_v", "ffn_gate_up_exps", "attn_norm"):
        assert got[key] is layer[key]
    for key in ("tok_embd", "output", "output_norm"):
        assert out[key] is params[key]
    # planes already present are kept, not rebuilt
    again = mmq.attach_mmq_planes(out)
    assert again["layers"][0]["attn_qk"] is got["attn_qk"]


def _jax_activation_quant(xf):
    """llamacog_tpu/ops/pallas/qmm_i8.py:105-108, as the engine's jit runs it."""
    xs = jnp.max(jnp.abs(xf), axis=1, keepdims=True) / 127.0
    xs = jnp.where(xs == 0, 1.0, xs)
    xq = jnp.clip(jnp.round(xf / xs), -127, 127).astype(jnp.int8)
    return xq, xs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_activation_quantization_bit_equal_to_jax(dtype):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((40, 1024)).astype(np.float32) * 3).to(dtype)
    x[5] = 0  # a zero row takes scale 1
    x[7, :4] = torch.tensor([127.0, 63.5, -0.5, 1.5], dtype=dtype)  # ties round to even
    xq, xs = quantize_activations(x)
    ref_q, ref_s = jax.jit(_jax_activation_quant)(jnp.asarray(x.float().numpy()))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(ref_q))
    np.testing.assert_array_equal(xs.numpy(), np.asarray(ref_s))
    assert xs[5].item() == 1.0 and xq.dtype == torch.int8 and xs.shape == (40, 1)


@pytest.mark.parametrize("kind,B", [("Q4_K", 256), ("Q4_K", 300), ("Q6_K", 256)])
def test_qmm_i8_plain_matches_pallas(kind, B):
    """The engine's jitted JAX qmm_i8 (Pallas K13 in interpret mode; B = 300
    pads to 512 rows there, and needs no padding here)."""
    qt, w = _with_planes(kind, 256, 1024, seed=B)
    x = np.random.default_rng(B + 1).standard_normal((B, 1024)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda a: jax_qmm_i8(a, qt, interpret=True))(jnp.asarray(x)))
    xq, xs = quantize_activations(torch.from_numpy(x))
    got = qmm_i8_plain(xq, xs, w.qi8, w.ws8T)
    assert got.dtype == torch.float32 and got.shape == (B, 256)
    assert rel_err(got.numpy(), ref) <= K13_TOL
    # the entry on a CPU tensor is the plain version
    assert torch.equal(qmm_i8(torch.from_numpy(x), w), got)


def test_qmatmul_dispatch_by_batch_and_planes(monkeypatch):
    """B < MMQ_MIN_B keeps the exact wire-format product bit for bit; at
    MMQ_MIN_B and above a weight with planes takes K13, and qmatmul_multi
    takes the int8 route (one quantization, K13 per weight: per-weight
    qmatmul's results) only when every weight has planes."""
    _, exact = _pair("Q4_K", 512, 1024, seed=7)
    _, w = _with_planes("Q4_K", 512, 1024, seed=7)
    _, w2 = _with_planes("Q6_K", 256, 1024, seed=8)
    rng = np.random.default_rng(9)
    small = torch.from_numpy(rng.standard_normal((2, 1024)).astype(np.float32))
    big = torch.from_numpy(rng.standard_normal((mmq.MMQ_MIN_B, 1024)).astype(np.float32))
    assert torch.equal(linear.qmatmul(small, w), qmm_plain(small, exact))
    got = linear.qmatmul(big, w)
    assert torch.equal(got, qmm_i8(big, w)) and not torch.equal(got, qmm_plain(big, exact))
    cos = torch.nn.functional.cosine_similarity(got.double().flatten(),
                                                qmm_plain(big, exact).double().flatten(), 0)
    assert cos > 0.999
    shared = linear.qmatmul_multi(big, [w, w2])
    assert len(shared) == 2 and all(torch.equal(a, linear.qmatmul(big, b))
                                    for a, b in zip(shared, (w, w2)))
    assert linear.qmatmul_multi(big, [w, exact]) is not None  # exact rides the fused launch
    assert linear.qmatmul_multi(small, [w, w2]) is not None
    monkeypatch.setattr(mmq, "MMQ_MIN_B", 2)  # read at call time
    assert torch.equal(linear.qmatmul(small, w), qmm_i8(small, w))


def test_shared_quantization_route_matches_per_weight_and_jax():
    """attn_qk (Q4_K) and attn_v (Q6_K) with planes through qmatmul_multi:
    one quantization of x, bit-equal to two per-weight qmatmul calls, and
    within K13_TOL of the JAX qmm_i8 (Pallas K13 in interpret mode) of
    each weight on the same seeded inputs."""
    qk_j, qk = _with_planes("Q4_K", 768, 1024, seed=21)
    v_j, v = _with_planes("Q6_K", 256, 1024, seed=22)
    x = np.random.default_rng(23).standard_normal((mmq.MMQ_MIN_B, 1024)).astype(np.float32)
    xt = torch.from_numpy(x)
    got = linear.qmatmul_multi(xt, [qk, v])
    assert [tuple(o.shape) for o in got] == [(mmq.MMQ_MIN_B, 768), (mmq.MMQ_MIN_B, 256)]
    for out, w, qt in zip(got, (qk, v), (qk_j, v_j)):
        assert torch.equal(out, linear.qmatmul(xt, w))
        ref = np.asarray(jax.jit(lambda a, q=qt: jax_qmm_i8(a, q, interpret=True))(jnp.asarray(x)))
        assert rel_err(out.numpy(), ref) <= K13_TOL


def test_quantize_entry_and_kernel_refusal():
    """quantize_i8 on a CPU tensor is the plain quantization; its kernel
    takes CUDA tensors only."""
    from llamacog_tpu_torch.ops.cuda.qmm_i8 import quantize_i8, quantize_kernel

    x = torch.from_numpy(np.random.default_rng(4).standard_normal((5, 512)).astype(np.float32))
    for a, b in zip(quantize_i8(x), quantize_activations(x)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="CUDA"):
        quantize_kernel(x)


def test_new_modules_import_no_jax():
    """The modules of the int8 prefill and per-layer decode routes, by name,
    in a fresh interpreter: no `jax`, nothing of `llamacog_tpu`."""
    code = ("import sys\n"
            "import llamacog_tpu_torch.quant.mmq, llamacog_tpu_torch.ops.cuda.qmm_i8\n"
            "import llamacog_tpu_torch.ops.cuda.flash_decode, llamacog_tpu_torch.ops.linear\n"
            "print(sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'llamacog_tpu' or m.startswith('llamacog_tpu.')))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


def test_qmm_i8_kernel_refuses_cpu_tensors():
    from llamacog_tpu_torch.ops.cuda.qmm_i8 import qmm_i8_kernel

    with pytest.raises(ValueError, match="CUDA"):
        qmm_i8_kernel(torch.zeros(4, 512, dtype=torch.int8), torch.ones(4, 1),
                      torch.zeros(256, 512, dtype=torch.int8), torch.ones(1, 256))


# ---------------------------------------------------------------------------
# The engine: LLAMACOG_MMQ=1 prefill against the JAX engine
# ---------------------------------------------------------------------------

PROMPT = list(range(2, 34))


@pytest.fixture(scope="module")
def mmq_gguf(tmp_path_factory):
    """A tiny Q4_K_M llama whose linears all pass the plane filter (K and N
    multiples of 512 and 256)."""
    from llamacog_tpu.tools.quantize import main as quantize_main
    from llamacog_tpu.utils.testing import make_tiny_llama_gguf

    d = tmp_path_factory.mktemp("mmq")
    src = str(d / "f32.gguf")
    make_tiny_llama_gguf(src, n_embd=512, n_head=8, n_head_kv=4, n_ff=1024,
                         quant_type=GGMLType.F32)
    q = str(d / "q4km.gguf")
    assert quantize_main([src, q, "Q4_K_M"]) == 0
    return q


def test_engine_mmq_prefill_matches_jax(mmq_gguf, monkeypatch):
    """f32 prefill logits of a 32-token prompt with MMQ_MIN_B patched to 8 in
    both packages (as tests/test_qmm_i8.py does), the JAX side on its
    Pallas backend. Each package builds its own planes, which
    test_mmq_planes_bit_equal_to_jax holds bit-equal."""
    import llamacog_tpu.quant.mmq as jax_mmq
    from llamacog_tpu.models.loader import load_model as jax_load_model
    from llamacog_tpu.ops import linear as jax_linear
    from llamacog_tpu.runtime.engine import Engine as JaxEngine
    from llamacog_tpu_torch.convert import from_reference, gguf_tensors
    from llamacog_tpu_torch.gguf import GGUFModelReader
    from llamacog_tpu_torch.models.config import ModelConfig
    from llamacog_tpu_torch.runtime.engine import Engine

    monkeypatch.setattr(jax_linear, "_BACKEND", "pallas")
    monkeypatch.setattr(jax_mmq, "MMQ_MIN_B", 8)
    monkeypatch.setattr(mmq, "MMQ_MIN_B", 8)
    reader = GGUFModelReader(mmq_gguf)
    cfg = ModelConfig.from_metadata(reader.metadata)
    tensors = gguf_tensors(reader)
    reader.close()

    def port_logits(params):
        eng = Engine(params, cfg, batch_size=1, max_seq=64, dtype=torch.float32, device="cpu")
        return eng.prefill(PROMPT)

    params = from_reference(cfg, tensors, device="cpu", dtype=torch.float32)
    exact = port_logits(params)
    monkeypatch.setenv("LLAMACOG_MMQ", "1")
    m = jax_load_model(mmq_gguf, with_tokenizer=False, dtype=jnp.float32)
    ref = np.asarray(JaxEngine(m.params, m.config, batch_size=1, max_seq=64,
                               dtype=jnp.float32).prefill(PROMPT), np.float32)
    got = port_logits(params)
    assert all(v.qi8 is None for v in params["layers"][0].values()
               if isinstance(v, wire.WireTensor))  # the engine attached to its own copy
    # both packages took the int8 route (5% from the exact logits), and
    # agree to the f32 rounding differences of the rest of the forward
    # (5.7e-7 measured); an int8 rounding flip would cost ~1e-3
    assert rel_err(exact, ref) > 1e-2
    assert rel_err(got, ref) < 1e-5
    cos = float(np.dot(got, exact) / (np.linalg.norm(got) * np.linalg.norm(exact)))
    assert cos > 0.995 and not np.array_equal(got, exact)


def test_one_quantization_per_layer_input(mmq_gguf, monkeypatch):
    """The int8 prefill quantizes each layer input once: the attention
    input (shared by the q/k/v weights), the attention output, the FFN
    input (gate and up) and the down projection's input, 4 a layer; every
    weight with planes runs K13 on one of them."""
    from llamacog_tpu_torch.convert import from_reference, gguf_tensors
    from llamacog_tpu_torch.gguf import GGUFModelReader
    from llamacog_tpu_torch.models.config import ModelConfig
    from llamacog_tpu_torch.ops.cuda import qmm_i8 as qmm_i8_mod
    from llamacog_tpu_torch.runtime.engine import Engine

    monkeypatch.setattr(mmq, "MMQ_MIN_B", 8)
    monkeypatch.setenv("LLAMACOG_MMQ", "1")
    reader = GGUFModelReader(mmq_gguf)
    cfg = ModelConfig.from_metadata(reader.metadata)
    tensors = gguf_tensors(reader)
    reader.close()
    params = from_reference(cfg, tensors, device="cpu", dtype=torch.float32)
    eng = Engine(params, cfg, batch_size=1, max_seq=64, dtype=torch.float32, device="cpu")
    calls = {"quantize": 0, "k13": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    quantize = counted("quantize", qmm_i8_mod.quantize_i8)
    k13 = counted("k13", qmm_i8_mod.qmm_i8_quantized)
    for mod in (qmm_i8_mod, linear):
        monkeypatch.setattr(mod, "quantize_i8", quantize)
        monkeypatch.setattr(mod, "qmm_i8_quantized", k13)
    eng.prefill(PROMPT)
    n_planes = [sum(getattr(v, "qi8", None) is not None for v in layer.values())
                for layer in eng.params["layers"]]
    assert min(n_planes) >= 4
    assert calls == {"quantize": 4 * cfg.n_layer, "k13": sum(n_planes)}
