"""The Qwen families of the generalized transformer in the port (qwen2,
qwen2moe, qwen3, qwen3moe), held against the JAX package.

Tiny random GGUFs (2 layers, widths 64-256) are written with the JAX
package's GGUFWriter and quantize_tensor (encode_np) and loaded by both
packages; the same prompt goes through both engines as f32 models: the
prefill logits within 1e-4 of max |logit| and 16 greedy tokens equal, with
the dense and the q8_0 cache. The cases: qwen2 all-Q8_0 (q/k/v fuse, their
biases concatenated into attn_qkv_b) and Q4_K_M-mixed (q/k/v apart, each
with its bias, no attn_qk fusion); qwen3 (per-head q/k norm, so no attn_qk
fusion either); qwen2moe (a shared expert with its sigmoid gate); qwen3moe
(16 experts, top 4: a 12-token prefill has 48 (token, slot) rows, past
_MOE_GATHER_MAX, so it takes the grouped path). :func:`write_gguf` is
shared with tests/test_torch_arch_gemma.py and tests/test_torch_wire_k32.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llamacog_tpu.gguf import GGMLType, GGUFWriter
from llamacog_tpu.models.loader import load_model as jax_load_model
from llamacog_tpu.quant import quantize_tensor
from llamacog_tpu.runtime.engine import Engine as JaxEngine
from llamacog_tpu_torch.models.config import ModelConfig
from llamacog_tpu_torch.models.loader import load_model
from llamacog_tpu_torch.quant import wire
from llamacog_tpu_torch.runtime.engine import Engine
from llamacog_tpu_torch.utils import synthetic

N_DECODE = 16
TOL = 1e-4  # of max |logit|: f32 models, summation order alone
PROMPT = [(i * 37) % 250 + 3 for i in range(12)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's torch ops on one thread: its models are a few hundred
    wide, so more threads buy nothing, and under the test runner's parallel
    workers they contend for the cores (the previous count is restored)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_gguf(path, arch: str, *, n_vocab=256, n_embd=64, n_layer=2, n_head=4, n_head_kv=2,
               head_dim=None, n_ff=128, qkv_bias=False, qk_norm=False, post_norms=False,
               tied=False, n_expert=0, n_expert_used=0, n_ff_exp=None, shexp_ff=0,
               shexp_gate=False, kind=None, metadata=None, seed=0, norm_bias=False,
               ffn_norm=True, fused_qkv=False, fused_up=False, mla=None, dense_lead=0,
               probs_bias=False, rope_factors=None, extra_tensors=None, ffn_gate=True,
               biases=(), n_pos=0, attn_norm_2=False, attn_norm=True, norms=True,
               moe_step=0, post_norm_names=("post_attention_norm", "post_ffw_norm"),
               moe_dense=0, bitnet=False) -> str:
    """A tiny random GGUF of `arch` with llama.cpp's tensor names. `kind`
    maps a tensor name to its GGMLType (None: F32; F16 stored as such); norms, biases and the
    routers stay F32, as llama.cpp keeps them. Norm weights are drawn near
    1, so a norm that is skipped or doubled shows. The other families'
    tensors: `norm_bias` (a bias on every norm), `ffn_norm=False` (command-r:
    the FFN reads the attention's norm), `fused_qkv` (one attn_qkv),
    `fused_up` (phi3's ffn_up of 2 x n_ff rows, no ffn_gate), `qk_norm="head"`
    (command-r-plus: a [heads, head_dim] norm), `mla` (deepseek2: a dict of
    kv_lora, q_lora (0: no q LoRA), rope, nope and v widths, in place of
    q/k/v), `dense_lead` (the first layers dense in a MoE file),
    `probs_bias` (exp_probs_b), `rope_factors` ((long, short) tables),
    `extra_tensors` ({name: array}), and the layer-norm families' tensors:
    `ffn_gate=False` (an FFN of ffn_up and ffn_down alone), `biases` (the
    products among attn_qkv, attn_output, ffn_gate, ffn_up, ffn_down and
    output that carry a bias), `n_pos` (rows of learned positions, position_embd.weight,
    of the kind `kind` gives it) and `attn_norm_2` (falcon-40B's second
    norm); and `norms=False` (olmo: no norm tensor at all), `attn_norm=False`
    (olmo2: no pre-norms), `qk_norm="full"` (olmo2, olmoe: q/k norms over the
    whole projection) and `moe_step` (llama4's interleave: MoE only in the
    layers il with (il + 1) % moe_step == 0, the others dense); and the MoE
    variants': `post_norm_names` (grok keeps its post-norms under
    attn_output_norm and layer_output_norm), `ffn_norm` as a name (dbrx's
    pre-FFN norm is attn_output_norm) and `moe_dense` (arctic: a dense FFN
    of that width and ffn_norm_exps beside the experts of a MoE layer); and
    the last decoders': `n_head`, `n_head_kv` and `n_ff` as per-layer lists
    (openelm, deci: written as arrays; a layer of no kv heads has attn_output
    alone where it has query heads, no attention at all where it has none,
    and a layer of FFN width 0 no FFN and no ffn_norm), `qk_norm="layer"`
    (chameleon: [heads, head_dim] norms with biases) and `bitnet` (the rms
    sub-norms before attn_output and ffn_down and a one-element scale,
    not 1, on each product)."""
    rng = np.random.default_rng(seed)

    def per_layer(v, il):
        return v[il] if isinstance(v, (list, tuple)) else v

    hd = head_dim or n_embd // max(per_layer(n_head, il) for il in range(n_layer))
    hd_k = hd_v = hd
    if mla:
        hd_k, hd_v = mla["nope"] + mla["rope"], mla["v"]
    ff_exp = n_ff_exp or n_ff
    w = GGUFWriter(path)
    w.add("general.architecture", arch)
    w.add("general.name", f"tiny-{arch}")
    for key, value in {"context_length": 512, "embedding_length": n_embd,
                       "block_count": n_layer, "feed_forward_length": n_ff,
                       "attention.head_count": n_head, "attention.head_count_kv": n_head_kv,
                       "attention.key_length": hd_k, "attention.value_length": hd_v,
                       "attention.layer_norm_rms_epsilon": 1e-6, "rope.freq_base": 10000.0,
                       "vocab_size": n_vocab}.items():
        w.add(f"{arch}.{key}", list(value) if isinstance(value, (list, tuple)) else value)
    if n_expert:
        w.add(f"{arch}.expert_count", n_expert)
        w.add(f"{arch}.expert_used_count", n_expert_used)
        w.add(f"{arch}.expert_feed_forward_length", ff_exp)
    if shexp_ff:
        w.add(f"{arch}.expert_shared_feed_forward_length", shexp_ff)
    if mla:
        w.add(f"{arch}.attention.kv_lora_rank", mla["kv_lora"])
        w.add(f"{arch}.rope.dimension_count", mla["rope"])
        if mla.get("q_lora"):
            w.add(f"{arch}.attention.q_lora_rank", mla["q_lora"])
    if dense_lead:
        w.add(f"{arch}.leading_dense_block_count", dense_lead)
    for key, value in (metadata or {}).items():
        w.add(key, value)
    toks = ["<unk>", "<s>", "</s>"] + [f"<0x{i:02X}>" for i in range(n_vocab - 3)]
    w.add("tokenizer.ggml.model", "llama")
    w.add("tokenizer.ggml.tokens", toks)
    w.add("tokenizer.ggml.scores", np.zeros(n_vocab, dtype=np.float32))
    w.add("tokenizer.ggml.token_type", np.array([2, 3, 3] + [6] * (n_vocab - 3), np.int32))
    w.add("tokenizer.ggml.bos_token_id", 1)
    w.add("tokenizer.ggml.eos_token_id", 2)

    def rand(*shape, s=0.05):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    def norm(name, *shape):
        if not norms:
            return
        w.add_tensor(name + ".weight", (1.0 + rand(*shape, s=0.1)).astype(np.float32))
        if norm_bias:
            w.add_tensor(name + ".bias", rand(*shape, s=0.1))

    def weight(name, arr):
        t = kind(name) if kind is not None else None
        if t is None or t == GGMLType.F32:
            w.add_tensor(name, arr)
        elif t == GGMLType.F16:
            w.add_tensor(name, arr.astype(np.float16))
        else:
            w.add_tensor(name, quantize_tensor(arr, t).tobytes(), shape=arr.shape, ggml_type=t)

    def bias(name, rows):
        if name.split(".")[-1] in biases:
            w.add_tensor(name + ".bias", rand(rows, s=0.2))

    weight("token_embd.weight", rand(n_vocab, n_embd, s=0.5))
    if n_pos:
        weight("position_embd.weight", rand(n_pos, n_embd, s=0.5))
    norm("output_norm", n_embd)
    if not tied:
        weight("output.weight", rand(n_vocab, n_embd))
        bias("output", n_vocab)
    if rope_factors is not None:
        for name, table in zip(("long", "short"), rope_factors):
            w.add_tensor(f"rope_factors_{name}.weight", np.asarray(table, np.float32))
    for il in range(n_layer):
        p = f"blk.{il}."
        hq, hk, ff = per_layer(n_head, il), per_layer(n_head_kv, il), per_layer(n_ff, il)
        if attn_norm:
            norm(p + "attn_norm", n_embd)
        if attn_norm_2:
            norm(p + "attn_norm_2", n_embd)
        if not mla and hk == 0:  # deci: attn_output alone, or no attention
            if hq:
                weight(p + "attn_output.weight", rand(n_embd, hq * hd_v))
        elif mla:
            q_rows, r = n_head * hd_k, mla["rope"]
            if mla.get("q_lora"):
                weight(p + "attn_q_a.weight", rand(mla["q_lora"], n_embd))
                norm(p + "attn_q_a_norm", mla["q_lora"])
                weight(p + "attn_q_b.weight", rand(q_rows, mla["q_lora"]))
            else:
                weight(p + "attn_q.weight", rand(q_rows, n_embd))
            weight(p + "attn_kv_a_mqa.weight", rand(mla["kv_lora"] + r, n_embd))
            norm(p + "attn_kv_a_norm", mla["kv_lora"])
            weight(p + "attn_kv_b.weight", rand(n_head * (mla["nope"] + hd_v), mla["kv_lora"]))
        elif fused_qkv:
            weight(p + "attn_qkv.weight", rand((hq + 2 * hk) * hd, n_embd))
            bias(p + "attn_qkv", (hq + 2 * hk) * hd)
        else:
            for nm, rows in (("attn_q", hq * hd), ("attn_k", hk * hd), ("attn_v", hk * hd)):
                weight(p + nm + ".weight", rand(rows, n_embd))
                if qkv_bias:
                    w.add_tensor(p + nm + ".bias", rand(rows, s=0.2))
        if hk == 0 and not mla:
            pass
        elif qk_norm == "head":
            norm(p + "attn_q_norm", hq, hd)
            norm(p + "attn_k_norm", hk, hd)
        elif qk_norm == "layer":
            for nm, heads in (("attn_q_norm", hq), ("attn_k_norm", hk)):
                w.add_tensor(p + nm + ".weight", (1.0 + rand(heads, hd, s=0.1)).astype(np.float32))
                w.add_tensor(p + nm + ".bias", rand(heads, hd, s=0.1))
        elif qk_norm == "full":
            norm(p + "attn_q_norm", hq * hd)
            norm(p + "attn_k_norm", hk * hd)
        elif qk_norm:
            norm(p + "attn_q_norm", hd)
            norm(p + "attn_k_norm", hd)
        if hk or mla:
            weight(p + "attn_output.weight", rand(n_embd, hq * hd_v))
            bias(p + "attn_output", n_embd)
        if bitnet and hk:
            norm(p + "attn_sub_norm", hq * hd_v)
            for nm in ("attn_q", "attn_k", "attn_v", "attn_output"):
                w.add_tensor(p + nm + ".scale", np.asarray([1.0 + 0.1 * (il + 1)], np.float32))
        if post_norms:
            for name in post_norm_names:
                norm(p + name, n_embd)
        is_moe = n_expert and il >= dense_lead and (not moe_step or (il + 1) % moe_step == 0)
        if ffn_norm and (ff or is_moe):
            norm(p + (ffn_norm if isinstance(ffn_norm, str) else "ffn_norm"), n_embd)
        if is_moe:
            w.add_tensor(p + "ffn_gate_inp.weight", rand(n_expert, n_embd, s=0.5))
            if probs_bias:
                w.add_tensor(p + "exp_probs_b.bias", rand(n_expert, s=0.5))
            weight(p + "ffn_gate_exps.weight", rand(n_expert, ff_exp, n_embd))
            weight(p + "ffn_up_exps.weight", rand(n_expert, ff_exp, n_embd))
            weight(p + "ffn_down_exps.weight", rand(n_expert, n_embd, ff_exp))
            if shexp_ff:
                weight(p + "ffn_gate_shexp.weight", rand(shexp_ff, n_embd))
                weight(p + "ffn_up_shexp.weight", rand(shexp_ff, n_embd))
                weight(p + "ffn_down_shexp.weight", rand(n_embd, shexp_ff))
                if shexp_gate:
                    w.add_tensor(p + "ffn_gate_inp_shexp.weight", rand(1, n_embd, s=0.5))
            if moe_dense:
                weight(p + "ffn_gate.weight", rand(moe_dense, n_embd))
                weight(p + "ffn_up.weight", rand(moe_dense, n_embd))
                weight(p + "ffn_down.weight", rand(n_embd, moe_dense))
                norm(p + "ffn_norm_exps", n_embd)
        elif not ff:
            pass
        elif fused_up:
            weight(p + "ffn_up.weight", rand(2 * ff, n_embd))
            weight(p + "ffn_down.weight", rand(n_embd, ff))
        else:
            if ffn_gate:
                weight(p + "ffn_gate.weight", rand(ff, n_embd))
                bias(p + "ffn_gate", ff)
            weight(p + "ffn_up.weight", rand(ff, n_embd))
            bias(p + "ffn_up", ff)
            weight(p + "ffn_down.weight", rand(n_embd, ff))
            bias(p + "ffn_down", n_embd)
            if bitnet:
                norm(p + "ffn_sub_norm", ff)
                for nm in ("ffn_gate", "ffn_up", "ffn_down"):
                    w.add_tensor(p + nm + ".scale", np.asarray([1.0 - 0.05 * (il + 1)], np.float32))
    for name, arr in (extra_tensors or {}).items():
        w.add_tensor(name, np.asarray(arr, np.float32))
    w.write()
    return str(path)


def q4_k_m_kinds(name: str):
    """A Q4_K_M file's kinds by llama.cpp's rules at 2 layers (both take
    use_more_bits), with its 32-block fallback where a row does not divide
    256 (utils/synthetic.py::tensor_kinds)."""
    if "attn_v" in name or "ffn_down" in name or name == "output.weight":
        return GGMLType.Q6_K
    return GGMLType.Q4_K


# one JAX engine per (file, engine settings) in a test process, reset before
# each use: its jitted steps compile once (a new engine compiles its own,
# most of a check's time here); reset empties it (every row at length 0: the
# cache's old contents are never attended)
_JAX_ENGINES = {}


def load_both(path, **engine):
    """(empty JAX engine, port engine, port model) of the file as f32 models
    on the CPU."""
    key = (path, tuple(sorted(engine.items())))
    if key not in _JAX_ENGINES:
        ref = jax_load_model(path, with_tokenizer=False, dtype=jnp.float32)
        _JAX_ENGINES[key] = JaxEngine(ref.params, ref.config, dtype=jnp.float32, **engine)
    jeng = _JAX_ENGINES[key]
    jeng.reset()
    got = load_model(path, dtype=torch.float32, device="cpu", with_tokenizer=False)
    return (jeng, Engine(got.params, got.config, dtype=torch.float32, device="cpu", **engine),
            got)


def check_same_run(path, kv_type="dense", prompt=PROMPT, n_decode=N_DECODE, max_seq=256):
    """The prefill logits within TOL of max |logit| and the greedy tokens
    equal, port against the JAX package; returns the port's engine."""
    ref, eng, _ = load_both(path, batch_size=1, max_seq=max_seq, kv_type=kv_type)
    want = np.asarray(ref.prefill(prompt))
    got = eng.prefill(prompt)
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= TOL * scale, kv_type
    first = np.array([int(np.argmax(want))])
    want_toks = np.asarray(ref.decode_greedy_tokens(first, n_decode))
    got_toks = eng.decode_greedy_tokens(first, n_decode)
    np.testing.assert_array_equal(got_toks, want_toks)
    return eng


CASES = {
    # q/k/v one kind: attn_qkv with the concatenated biases
    "qwen2 Q8_0": dict(arch="qwen2", qkv_bias=True, kind=lambda n: GGMLType.Q8_0,
                       n_embd=256, n_ff=256),
    # Q4_K attn_q/attn_k and Q6_K attn_v, each biased: three launches
    "qwen2 Q4_K_M": dict(arch="qwen2", qkv_bias=True, kind=q4_k_m_kinds, n_embd=256,
                         n_ff=256),
    "qwen3": dict(arch="qwen3", qk_norm=True, kind=q4_k_m_kinds, n_embd=256, n_ff=256,
                  head_dim=64),
    "qwen2moe": dict(arch="qwen2moe", qkv_bias=True, n_expert=4, n_expert_used=2,
                     n_ff_exp=64, shexp_ff=96, shexp_gate=True),
    # q 4 x 32 = 128 wide over n_embd 64, as Qwen3-30B-A3B's q is wider than n_embd
    "qwen3moe": dict(arch="qwen3moe", qk_norm=True, n_expert=16, n_expert_used=4,
                     n_ff_exp=32, head_dim=32, metadata={"qwen3moe.expert_weights_norm": True}),
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("arch_qwen")
    return {name: write_gguf(str(root / f"{name.replace(' ', '_')}.gguf"), **case)
            for name, case in CASES.items()}


@pytest.mark.parametrize("kv_type", ["dense", "q8_0"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_greedy_tokens_match_jax(files, case, kv_type):
    check_same_run(files[case], kv_type)


def test_fusions_follow_the_jax_loader(files):
    """The keys of each file's first layer in the port are the JAX
    loader's: q/k/v fused with attn_qkv_b where their kinds agree; no
    attn_qk where q carries a bias (qwen2) or a norm (qwen3)."""
    want = {"qwen2 Q8_0": {"attn_qkv", "attn_qkv_b"},
            "qwen2 Q4_K_M": {"attn_q", "attn_k", "attn_v", "attn_q_b", "attn_k_b", "attn_v_b"},
            "qwen3": {"attn_q", "attn_k", "attn_v", "attn_q_norm", "attn_k_norm"}}
    for case, keys in want.items():
        ref = jax_load_model(files[case], with_tokenizer=False, dtype=jnp.float32)
        got = load_model(files[case], dtype=torch.float32, device="cpu", with_tokenizer=False)
        assert set(got.params["layers"][0]) == set(ref.params["layers"][0]), case
        assert keys <= set(got.params["layers"][0]), case
        assert "attn_qk" not in got.params["layers"][0], case
        for key in ("attn_qkv_b", "attn_q_b", "attn_q_norm"):
            if key in keys:  # biases and norms stay f32, as the JAX loader keeps them
                assert got.params["layers"][0][key].dtype == torch.float32, case


def test_qwen3moe_routing_without_the_norm_key(tmp_path):
    """llama.cpp's qwen3moe graph normalizes the top-k weights, but
    config.py sets expert_weights_norm only from the GGUF key and gives
    qwen3moe no default (ROADMAP §3.5): a file without the key routes
    unnormalized in both packages alike, and the port keeps that parity."""
    case = dict(CASES["qwen3moe"], metadata={})
    path = write_gguf(str(tmp_path / "qwen3moe_nokey.gguf"), **case)
    ref = jax_load_model(path, with_tokenizer=False, dtype=jnp.float32)
    assert ref.config.expert_weights_norm is False
    assert load_model(path, device="cpu", with_tokenizer=False).config.expert_weights_norm \
        is False
    check_same_run(path)


def test_unported_archs_and_features_raise_by_name():
    base = synthetic.qwen3_8b_config(n_layer=2)
    for arch in ("neo-bert", "jamba", "t5", "rwkv6"):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            Engine({"layers": []}, ModelConfig(**{**base.__dict__, "arch": arch}),
                   device="cpu")
    for field, value, words in (("norm_type", "layer", "layer norm"),
                                ("parallel_residual", True, "parallel residual"),
                                ("use_alibi", True, "ALiBi"),
                                ("learned_pos_embd", True, "learned positions"),
                                ("n_lora_kv", 64, "MLA"),
                                ("n_head_arr", (4, 4), "per-layer head counts"),
                                ("swa_type", "chunked", "chunked SWA"),
                                ("moe_weight_before", True, "MoE weights before"),
                                ("n_ff_shexp", 64, "shared experts")):
        cfg = ModelConfig(**{**base.__dict__, field: value})
        with pytest.raises(NotImplementedError, match=words):
            Engine({"layers": []}, cfg, device="cpu")


_SYNTH_CASES = {
    "qwen2": dict(arch="qwen2", qkv_bias=True),
    "qwen3": dict(arch="qwen3", qk_norm=True),
    "qwen2moe": dict(arch="qwen2moe", qkv_bias=True, n_expert=4, n_expert_used=2,
                     n_ff_exp=256, shexp_ff=512, shexp_gate=True),
    "gemma3": dict(arch="gemma3", qk_norm=True, post_norms=True, tied=True, head_dim=128,
                   metadata={"gemma3.attention.sliding_window": 8}),
    "phi3": dict(arch="phi3", fused_qkv=True, fused_up=True,
                 rope_factors=(np.linspace(1.0, 4.0, 32), np.ones(32)),
                 metadata={"phi3.rope.scaling.original_context_length": 256}),
    "command-r": dict(arch="command-r", ffn_norm=False, tied=True),
    # the dense lead layer, then MoE with two ungated shared experts; K 64
    # of the MLA's LoRA products takes the 32-block fallback
    "deepseek2": dict(arch="deepseek2", n_head=4, n_head_kv=4, dense_lead=1, n_expert=4,
                      n_expert_used=2, n_ff_exp=64, shexp_ff=128,
                      mla={"kv_lora": 64, "q_lora": 64, "rope": 16, "nope": 48, "v": 64},
                      metadata={"deepseek2.expert_shared_count": 2}),
}


@pytest.mark.parametrize("case", sorted(_SYNTH_CASES))
def test_synthetic_params_are_a_loaded_file(tmp_path, case):
    """make_synthetic_params at a file's geometry has the keys, kinds and
    shapes the port loads from a Q4_K_M file of that geometry whose kinds
    are utils/synthetic.py's table (the runs on the card stand for such
    files): the biases, norms, shared expert and tied head included."""
    synthetic_matches_file(tmp_path, dict(_SYNTH_CASES[case], n_embd=256, n_ff=512))


def synthetic_matches_file(tmp_path, geo: dict) -> None:
    """The check of test_synthetic_params_are_a_loaded_file at the
    write_gguf geometry `geo` (shared with the layer-norm families' tests)."""
    cfg = load_model(write_gguf(str(tmp_path / "f32.gguf"), **geo), device="cpu",
                     with_tokenizer=False).config
    # a GGUF says it is tied by lacking output.weight; the config says it so
    cfg.tie_word_embeddings = geo.get("tied", False)
    table = synthetic.tensor_kinds(cfg, "Q4_K_M")

    def kind(name):
        if name.startswith("blk."):
            il, part = name.split(".")[1:3]
            lk = table["layers"][int(il)]
            part = part.removesuffix("_exps")
            return GGMLType[lk[part]] if part in lk else None
        top = name.split(".")[0]  # a table the rules leave dense (position_embd) is F32
        return GGMLType[table[top]] if top in table else None

    got = load_model(write_gguf(str(tmp_path / "q.gguf"), kind=kind, **geo),
                     dtype=torch.float32, device="cpu", with_tokenizer=False).params
    syn = synthetic.make_synthetic_params(cfg, device="cpu", ftype="Q4_K_M")
    assert set(got) == set(syn)
    for lg, ls in zip(got["layers"], syn["layers"]):
        assert set(lg) == set(ls)
        for key, w in lg.items():
            s = ls[key]
            if isinstance(w, wire.WireTensor):
                assert (s.kind, s.shape) == (w.kind, w.shape), key
            elif key != "ffn_gate_inp" and not key.endswith("_scale"):
                # the file's router and bitnet's scales are F32 in the model
                # dtype (f32 here; the synthetic scales bf16, a bf16 model's)
                assert (s.dtype, tuple(s.shape)) == (w.dtype, tuple(w.shape)), key
            else:
                assert tuple(s.shape) == tuple(w.shape), key


def _spm_metadata() -> dict:
    """A Gemma-like SPM vocab: the specials, the 256 byte-fallback tokens and
    scored pieces (whole words, subwords, the space marker)."""
    pieces = ["▁", "e", "t", "h", "o", "s", "▁t", "▁th", "▁the", "▁d", "▁do", "▁dog", "▁h",
              "▁he", "▁hel", "▁hell", "▁hello", "▁w", "▁wo", "▁wor", "ld", "▁world", "in",
              "ing", "▁g", "▁go", "▁f", "▁fo", "▁fox", "▁<", "start_of_turn", "user"]
    tokens = ["<pad>", "<eos>", "<bos>"] + [f"<0x{i:02X}>" for i in range(256)] + pieces
    scores = [0.0] * 259 + [-float(i) for i in range(len(pieces))]
    types = [3, 3, 3] + [6] * 256 + [1] * len(pieces)
    return {"tokenizer.ggml.model": "llama", "tokenizer.ggml.tokens": tokens,
            "tokenizer.ggml.scores": np.asarray(scores, np.float32),
            "tokenizer.ggml.token_type": np.asarray(types, np.int32),
            "tokenizer.ggml.bos_token_id": 2, "tokenizer.ggml.eos_token_id": 1}


def test_family_tokenizers_and_templates_match_jax():
    """The Qwen files' BPE under the `qwen2` pre-tokenizer, Gemma's SPM, and
    the chatml (Qwen) and gemma chat templates: the port's ids and text are
    the JAX package's."""
    from llamacog_tpu.runtime import chat as jax_chat
    from llamacog_tpu.tokenizer import BpeTokenizer as JaxBpe
    from llamacog_tpu.tokenizer import SpmTokenizer as JaxSpm
    from llamacog_tpu.tokenizer import Vocab as JaxVocab
    from llamacog_tpu_torch.runtime import chat
    from llamacog_tpu_torch.tokenizer import BpeTokenizer, SpmTokenizer, Vocab

    from .test_torch_bpe import TEXTS, _metadata

    texts = TEXTS + ["the quick brown fox jumps over the lazy dog", "hello world going",
                     "<start_of_turn>user\nhello<end_of_turn>"]
    for md, port_cls, ref_cls in ((_metadata("qwen2"), BpeTokenizer, JaxBpe),
                                  (_spm_metadata(), SpmTokenizer, JaxSpm)):
        port, ref = port_cls(Vocab.from_metadata(md)), ref_cls(JaxVocab.from_metadata(md))
        for text in texts:
            for add_special in (False, True):
                assert port.tokenize(text, add_special=add_special) == ref.tokenize(
                    text, add_special=add_special), (md["tokenizer.ggml.model"], text)
    messages = [{"role": "system", "content": "Be brief."},
                {"role": "user", "content": "Hi there"},
                {"role": "assistant", "content": "Hello."},
                {"role": "user", "content": "What is 2 + 2?"}]
    for name in ("chatml", "gemma"):
        for add_ass in (False, True):
            assert chat.apply_builtin_template(name, messages, add_ass) == \
                jax_chat.apply_builtin_template(name, messages, add_ass), name
