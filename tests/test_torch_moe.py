"""The port's sparse MoE (quant/wire.py stacked experts, ops/cuda/qmm_id.py,
models/llama.py::_ffn_moe) against the JAX package, on the CPU.

The same GGUF blocks, made from a numpy seed, go to both packages. The plain
gather / ragged / offset products are held against the JAX Pallas kernels
run in interpret mode (nmse < 2e-4, the JAX package's own bound in
tests/test_moe_sparse.py: the Pallas kernels round x and the weights to
bf16, the plain versions keep f32 operands where the port's kernels do).
The MoE FFN and the whole slice are held against the JAX forward in f32,
where both sides multiply f32 operands and differ in summation order only:
nmse < 1e-6 and identical routing, and identical greedy tokens.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llamacog_tpu.gguf import GGMLType
from llamacog_tpu.models import llama as jax_llama
from llamacog_tpu.models.config import ModelConfig as JaxConfig
from llamacog_tpu.models.loader import load_model as jax_load_model
from llamacog_tpu.ops.pallas import qmm_id as jax_qmm_id
from llamacog_tpu.quant import quantize
from llamacog_tpu.quant.planar import QuantTensor, decode, from_gguf
from llamacog_tpu.runtime.engine import Engine as JaxEngine
from llamacog_tpu.utils.testing import make_tiny_llama_gguf
from llamacog_tpu_torch.convert import from_reference, gguf_tensors
from llamacog_tpu_torch.gguf import GGUFModelReader
from llamacog_tpu_torch.models import llama
from llamacog_tpu_torch.models.config import ModelConfig
from llamacog_tpu_torch.models.loader import load_model
from llamacog_tpu_torch.ops.cuda import qmm_id
from llamacog_tpu_torch.quant import wire
from llamacog_tpu_torch.runtime.engine import Engine

from .test_torch_arch_qwen import one_torch_thread  # noqa: F401 (an autouse fixture)

N_EXP, N, K = 4, 256, 512
# every wire kind of the port: a Q4_K_M file's experts (Q4_K, Q6_K), and the
# experts of llama.cpp's other presets
KINDS = ["Q4_K", "Q6_K", "Q8_0", "Q5_K", "Q4_0", "Q4_1", "Q5_0", "Q5_1", "Q2_K", "Q3_K"]
PROMPT = [(i * 37) % 250 + 3 for i in range(20)]  # > 16 tokens: a ragged prefill
N_DECODE = 8
_TINY = dict(arch="llama", n_vocab=256, n_ctx_train=256, n_embd=256, n_layer=1, n_head=4,
             n_head_kv=2, n_ff=512, head_dim_k=64, head_dim_v=64)


def nmse(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return ((a - b) ** 2).sum() / max((b**2).sum(), 1e-20)


def _experts(kind, n_exp, n, k, seed):
    """The same random expert stack as a JAX planar QuantTensor and a port
    WireTensor, and its raw GGUF bytes."""
    t = getattr(GGMLType, kind)
    rng = np.random.default_rng(seed)
    raw = quantize(rng.standard_normal((n_exp, n, k)).astype(np.float32).reshape(-1), t)
    qt = from_gguf(raw, t, (n_exp, n, k))
    qt.planes = {name: jnp.asarray(v) for name, v in qt.planes.items()}
    return qt, wire.from_bytes(raw, t, (n_exp, n, k))


def _gguf(path, quant_type):
    return make_tiny_llama_gguf(str(path), n_embd=256, n_ff=512, n_expert=4, n_expert_used=2,
                                quant_type=quant_type,
                                extra_metadata={"llama.expert_weights_norm": True})


@pytest.fixture(scope="module")
def q4k_moe(tmp_path_factory):
    return _gguf(tmp_path_factory.mktemp("moe") / "q4k.gguf", GGMLType.Q4_K)


@pytest.fixture(scope="module")
def f32_moe(tmp_path_factory):
    return _gguf(tmp_path_factory.mktemp("moe") / "f32.gguf", GGMLType.F32)


# (a) stacked experts in wire format


@pytest.mark.parametrize("kind", KINDS)
def test_stacked_from_bytes_and_expert_fusion(kind):
    qg, wg = _experts(kind, 3, 64, 512, seed=1)
    qu, wu = _experts(kind, 3, 64, 512, seed=2)
    assert wg.shape == (3, 64, 512) and wg.blocks.shape[0] == 3 * 64
    dg = wire.dequantize(wg).numpy()
    np.testing.assert_array_equal(dg, np.asarray(decode(qg, jnp.float32)).reshape(3, 64, 512))
    ids = torch.tensor([2, 0, 2])
    np.testing.assert_array_equal(wire.dequantize_experts(wg, ids).numpy(), dg[[2, 0, 2]])
    fused = wire.fuse_experts(wg, wu)
    assert fused.shape == (3, 128, 512)
    want = np.concatenate([dg, wire.dequantize(wu).numpy()], axis=1)
    np.testing.assert_array_equal(wire.dequantize(fused).numpy(), want)
    assert wire.fuse_experts(wg, _experts("Q6_K" if kind == "Q4_K" else "Q4_K",
                                          3, 64, 512, seed=3)[1]) is None


def test_from_reference_matches_jax_loader_moe(q4k_moe):
    """Same keys as the JAX loader's tree (ffn_gate_up_exps fused per
    expert, a Q4_K router); every tensor dequantizes bit for bit to the JAX
    tensor's planar.decode."""
    ref = jax_load_model(q4k_moe, with_tokenizer=False, dtype=jnp.float32).params
    reader = GGUFModelReader(q4k_moe)
    cfg = ModelConfig.from_metadata(reader.metadata)
    got = from_reference(cfg, gguf_tensors(reader), device="cpu", dtype=torch.float32)
    reader.close()
    assert cfg.n_expert == 4 and cfg.n_expert_used == 2 and cfg.expert_weights_norm
    layer = got["layers"][0]
    assert layer["ffn_gate_up_exps"].shape == (4, 1024, 256)
    assert isinstance(layer["ffn_gate_inp"], wire.WireTensor)
    assert set(got) == set(ref)
    for lg, lr in zip(got["layers"], ref["layers"]):
        assert set(lg) == set(lr)
        for key in lg:
            assert isinstance(lg[key], wire.WireTensor) == isinstance(lr[key], QuantTensor)
            a = wire.dequantize(lg[key]) if isinstance(lg[key], wire.WireTensor) else lg[key]
            b = decode(lr[key], jnp.float32) if isinstance(lr[key], QuantTensor) else lr[key]
            np.testing.assert_array_equal(a.numpy().reshape(-1), np.asarray(b).reshape(-1))


# (b) the plain products against the Pallas kernels in interpret mode


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("entry", ["gather", "offset"])
def test_gather_plain_matches_pallas(kind, entry):
    qt, wt = _experts(kind, N_EXP, N, K, seed=5)
    rng = np.random.default_rng(6)
    S = 6
    x = rng.standard_normal((S, K)).astype(np.float32)
    ids = rng.integers(0, N_EXP, S).astype(np.int32)
    jax_fn = {"gather": jax_qmm_id.qmm_gather, "offset": jax_qmm_id.qmm_gather_offset}[entry]
    ref = np.asarray(jax_fn(jnp.asarray(x), jnp.asarray(ids), qt, interpret=True))
    fn = {"gather": qmm_id.qmm_gather, "offset": qmm_id.qmm_gather_offset}[entry]
    got = fn(torch.from_numpy(x), torch.from_numpy(ids), wt)
    assert got.dtype == torch.float32 and got.shape == (S, N)
    assert nmse(got.numpy(), ref) < 2e-4
    assert torch.equal(got, qmm_id.qmm_gather_plain(torch.from_numpy(x),
                                                    torch.from_numpy(ids), wt))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("bf16", [False, True])
def test_ragged_plain_matches_pallas(kind, bf16):
    """tt = 64 tiles with an empty expert (2) between used ones."""
    qt, wt = _experts(kind, N_EXP, N, K, seed=7)
    tt = 64
    tile_expert = np.array([0, 1, 1, 3], dtype=np.int32)
    xs = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (len(tile_expert) * tt, K)).astype(np.float32))
    if bf16:
        xs = xs.to(torch.bfloat16)
    ref = np.asarray(jax_qmm_id.qmm_ragged(jnp.asarray(xs.float().numpy()),
                                           jnp.asarray(tile_expert), qt, tt, interpret=True))
    got = qmm_id.qmm_ragged(xs, torch.from_numpy(tile_expert), wt, tt)
    assert got.dtype == torch.float32 and got.shape == (len(tile_expert) * tt, N)
    assert nmse(got.numpy(), ref) < 2e-4


@pytest.mark.parametrize("kind", KINDS)
def test_ragged_plain_matches_pallas_model_tile(kind):
    """The model's token tile (qmm_id.RAGGED_TILE, 16) on moe_sort's layout
    of 20 (token, slot) pairs: expert 2 empty, expert 3 a single row (its
    tile 15 rows of padding), and padding tiles past the last expert."""
    qt, wt = _experts(kind, N_EXP, N, K, seed=11)
    tt = qmm_id.RAGGED_TILE
    ids = torch.tensor([0, 1] * 6 + [1, 0] * 3 + [3, 0], dtype=torch.int32)
    dest, tile_expert, s_pad = llama.moe_sort(ids, N_EXP, tt)
    counts = torch.bincount(ids.long(), minlength=N_EXP).tolist()
    assert tt == 16 and counts[2] == 0 and counts[3] == 1
    rows = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (ids.shape[0], K)).astype(np.float32))
    xs = torch.zeros(s_pad, K).index_copy_(0, dest, rows).to(torch.bfloat16)
    ref = np.asarray(jax_qmm_id.qmm_ragged(jnp.asarray(xs.float().numpy()),
                                           jnp.asarray(tile_expert.numpy()), qt, tt,
                                           interpret=True))
    got = qmm_id.qmm_ragged(xs, tile_expert, wt, tt)
    assert got.shape == (s_pad, N)
    assert nmse(got.numpy(), ref) < 2e-4
    pad = (tile_expert >= N_EXP).repeat_interleave(tt)
    assert pad.any() and (got[pad] == 0).all()


def test_padding_tiles_and_rows_give_zeros():
    """Experts outside [0, n_exp) mark the sort's padding: zeros, no weights."""
    _, wt = _experts("Q4_K", N_EXP, N, K, seed=9)
    xs = torch.ones(3 * 64, K)
    out = qmm_id.qmm_ragged(xs, torch.tensor([1, N_EXP, N_EXP], dtype=torch.int32), wt, 64)
    assert out[64:].abs().max() == 0 and out[:64].abs().max() > 0
    out = qmm_id.qmm_gather(xs[:2], torch.tensor([N_EXP, 0], dtype=torch.int32), wt)
    assert out[0].abs().max() == 0 and out[1].abs().max() > 0


@pytest.mark.parametrize("n_pairs", [2, 5, 64, 300, 4096])
def test_moe_sort_layout(n_pairs):
    """Every pair lands in a tile of its own expert, tiles start on expert
    boundaries, and the bound s_pad depends on the row count alone (4096:
    a 2048-token prefill chunk at top-2)."""
    rng = np.random.default_rng(n_pairs)
    ids = torch.from_numpy(rng.integers(0, 3, n_pairs).astype(np.int32))  # expert 3 unused
    dest, tile_expert, s_pad = llama.moe_sort(ids, 4, 64)
    assert s_pad == (n_pairs + 4 * 63 + 63) // 64 * 64 and tile_expert.dtype == torch.int32
    assert len(set(dest.tolist())) == n_pairs and int(dest.max()) < s_pad
    assert torch.equal(tile_expert[dest // 64], ids)
    used = int((torch.bincount(ids.long(), minlength=4) + 63).div(64, rounding_mode="floor")
               .sum())
    assert (tile_expert[used:] == 4).all() and (tile_expert[:used] < 4).all()


def test_moe_sort_layout_model_tile():
    """moe_sort at the model's token tile: the same layout rules at 16 rows,
    and the bound s_pad a function of the row count alone."""
    tt = qmm_id.RAGGED_TILE
    for n_pairs in (64, 256, 1024):
        ids = torch.from_numpy(np.random.default_rng(n_pairs).integers(0, 3, n_pairs)
                               .astype(np.int32))
        dest, tile_expert, s_pad = llama.moe_sort(ids, 4, tt)
        assert s_pad == (n_pairs + 4 * (tt - 1) + tt - 1) // tt * tt
        assert len(set(dest.tolist())) == n_pairs and int(dest.max()) < s_pad
        assert torch.equal(tile_expert[dest // tt], ids)
        assert llama._MOE_TILE == tt


# (c) the MoE FFN against the JAX forward's


def _moe_layer(seed):
    """One MoE layer (E=256, F=512, 4 experts) in both packages."""
    rng = np.random.default_rng(seed)
    gate_inp = (rng.standard_normal((N_EXP, 256)) * 0.5).astype(np.float32)
    (qg, wg), (qu, wu) = _experts("Q4_K", N_EXP, 512, 256, seed), \
        _experts("Q4_K", N_EXP, 512, 256, seed + 1)
    qd, wd = _experts("Q6_K", N_EXP, 256, 512, seed + 2)
    jax_layer = {"ffn_gate_inp": jnp.asarray(gate_inp), "ffn_gate_exps": qg,
                 "ffn_up_exps": qu, "ffn_down_exps": qd}
    port_layer = {"ffn_gate_inp": torch.from_numpy(gate_inp),
                  "ffn_gate_up_exps": wire.fuse_experts(wg, wu), "ffn_down_exps": wd}
    return jax_layer, port_layer


@pytest.mark.parametrize("T", [2, 48])  # 4 pairs: the gather; 96: the ragged GEMM
def test_ffn_moe_matches_jax_f32(T):
    kw = dict(_TINY, n_expert=N_EXP, n_expert_used=2, expert_weights_norm=True)
    jcfg, cfg = JaxConfig(**kw), ModelConfig(**kw)
    jax_layer, port_layer = _moe_layer(seed=T)
    x = np.random.default_rng(T + 100).standard_normal((1, T, 256)).astype(np.float32)
    ref_i, ref_w = jax_llama._moe_router(jax_layer, jnp.asarray(x), jcfg)
    top_i, gate_w = llama._moe_router(port_layer, torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(ref_i))
    assert nmse(gate_w.numpy(), np.asarray(ref_w)) < 1e-12
    ref = np.asarray(jax_llama._ffn_moe(jax_layer, jnp.asarray(x), jcfg))
    got = llama._ffn_moe(port_layer, torch.from_numpy(x), cfg)
    assert got.dtype == torch.float32 and got.shape == (1, T, 256)
    assert nmse(got.numpy(), ref) < 1e-6


# (d) the slice: Engine in both packages


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


@pytest.mark.parametrize("gguf", ["q4k_moe", "f32_moe"])
def test_engine_greedy_tokens_match_jax(gguf, request):
    """Q4_K experts: the ragged GEMM at prefill, the gather at decode; F32
    experts: the dense all-expert einsums."""
    path = request.getfixturevalue(gguf)
    ref_logits, ref_toks = _run(path, port=False)
    logits, toks = _run(path, port=True)
    assert int(np.argmax(logits)) == int(np.argmax(ref_logits))
    np.testing.assert_allclose(logits, ref_logits, atol=2e-3, rtol=1e-3)
    assert toks.shape == (1, N_DECODE)
    np.testing.assert_array_equal(toks, ref_toks)


def test_moe_paths_taken(q4k_moe, monkeypatch):
    """The Q4_K run reaches the ragged product at prefill and the gather at
    decode, and never the dense einsum branch."""
    calls = {"ragged": 0, "gather": 0}
    for name, entry in (("ragged", "qmm_ragged"), ("gather", "qmm_gather")):
        orig = getattr(qmm_id, entry)

        def counted(*a, _orig=orig, _name=name):
            calls[_name] += 1
            return _orig(*a)
        monkeypatch.setattr(qmm_id, entry, counted)
    m = load_model(q4k_moe, dtype=torch.float32, device="cpu", with_tokenizer=False)
    eng = Engine(m.params, m.config, max_seq=64, dtype=torch.float32, device="cpu")
    eng.prefill(PROMPT)
    assert calls == {"ragged": 2 * 2, "gather": 0}  # 2 layers: gate_up, down
    eng.decode_one([5])
    assert calls == {"ragged": 4, "gather": 4}


@pytest.mark.parametrize("S,n_exp,grouped", [
    (1, 8, False), (2, 8, False), (8, 8, False), (15, 8, False), (16, 8, True), (32, 8, True),
    (16, 16, False), (32, 16, True), (32, 40, False), (32, 128, False), (33, 8, False)])
def test_gather_groups_rule(S, n_exp, grouped):
    """K10 groups rows by expert only for up to 32 rows and at least twice
    as many rows as experts (so never one token's top k, which share no
    expert), a function of the shapes alone."""
    assert qmm_id.gather_groups(S, n_exp) == grouped


def test_bf16_prefill_logits_close_to_jax(q4k_moe):
    """bf16 rounds at other points in the two packages (the JAX CPU path
    multiplies bf16 weights; the port's gather keeps f32 weights), and a
    changed router logit may flip a top-2 choice: a logits bound of a few
    bf16 ulps of the largest logit, as the dense model's bf16 test."""
    out = []
    for port in (False, True):
        if port:
            m = load_model(q4k_moe, dtype=torch.bfloat16, device="cpu", with_tokenizer=False)
            eng = Engine(m.params, m.config, max_seq=512, dtype=torch.bfloat16, device="cpu")
        else:
            m = jax_load_model(q4k_moe, with_tokenizer=False, dtype=jnp.bfloat16)
            eng = JaxEngine(m.params, m.config, batch_size=1, max_seq=512, dtype=jnp.bfloat16)
        out.append(np.asarray(eng.prefill(PROMPT), np.float32))
    ref, got = out
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() / np.abs(ref).max() < 3e-2


def test_check_supported_moe_rules():
    kw = dict(_TINY, n_expert=4, n_expert_used=2)
    llama.check_supported(ModelConfig(**kw))
    with pytest.raises(NotImplementedError, match="shared experts"):
        llama.check_supported(ModelConfig(**kw, n_expert_shared=1))
    with pytest.raises(NotImplementedError, match="before the experts"):
        llama.check_supported(ModelConfig(**kw, moe_weight_before=True))


# (e) the CLI


def test_cli_generates_from_moe_gguf_on_cpu(q4k_moe, capsys):
    from llamacog_tpu_torch.tools.cli import main

    assert main(["-m", q4k_moe, "-p", "hello moe", "-n", "4", "--device", "cpu",
                 "--dtype", "f32", "-c", "64"]) == 0
    out = capsys.readouterr()
    assert out.out.startswith("hello moe") and "[perf]" in out.err
