"""The generalized transformer forward pass (PyTorch).

Counterpart of llamacog_tpu/models/llama.py::forward for the llama, Qwen,
Gemma, Phi-3, Command-R and DeepSeek-V2 families, the layer-norm
families (phi2, gpt2, starcoder, starcoder2, falcon, gptneox, gptj,
stablelm), Llama 4, the OLMo families (olmo, olmo2, olmoe), the scaled
families (granite, granitemoe, minicpm), the ALiBi families (bloom, mpt,
refact, jais), the llama-graph clones (xverse, baichuan, internlm2,
exaone, orion, codeshell, qwen, plamo), the squared-ReLU FFN (nemotron,
arcee), the MoE variants (deepseek, dots1, bailingmoe, phimoe, grok,
arctic, dbrx) and the last decoders (MLA with minicpm's scales in minicpm3
and without in plm; glm4 and chatglm; chameleon; bitnet; the per-layer head
counts of openelm and deci): embedding (times sqrt(n_embd) on
Gemma, the embedding scale on granite, minicpm, minicpm3 and grok; plus the learned
position rows on gpt2 and starcoder; then bloom's embedding layer norm) ->
per layer (rms norm, or layer norm
with its bias where the file has one (dbrx's has none; phimoe's rms norms
carry one), q/k/v projections, pre-fused (phi3,
phi2, falcon, gpt2, starcoder, gptneox, dbrx) or with their biases (qwen2,
stablelm, starcoder2, phimoe, glm4, chatglm), per-head q/k norm (qwen3,
gemma3, command-r-plus, dots1, openelm), chameleon's per-head layer norm,
or one over the whole projection (olmo2, olmoe), olmo's, mpt's and dbrx's
clamp of q/k/v, bitnet's scale of each product,
rope, full or partial (phi2, gptneox, stablelm, gptj, glm4, chatglm;
interleaved on gptj and the GLM family),
where the arch has it (gemma3's local layers with a table of their own;
none on cohere2's global layers, gpt2 or starcoder; none on llama4's NoPE
layers, whose q takes the attention temperature instead, and the weightless
L2 q/k norm after it on its other layers; phi3's long or short
factors by context length), or the MLA of deepseek2, minicpm3 and plm in
its decompressed form (a q LoRA or a plain q, the compressed kv and its
rope part, decompressed to one K and V a head: 192/128 on deepseek2,
96/64 on minicpm3; an MLA layer takes no residual scale, the JAX branch's
order), openelm's and deci's per-layer head counts (each layer's own
heads, its K/V padded to the cache's; deci's attention-free, "linear
attention" and FFN-free layers), attention over the old cache plus the
current block (sliding-window layers over their window; a ring of the last
`window` tokens where the cache keeps one, runtime/kv_cache.py::SwaKVCache;
llama4's chunked layers within their chunk, every layer through the masked
path; ALiBi's per-head distance bias, also on the masked path alone, with
no rope; per-layer head counts there too; grok's softcap of 30 after its
fixed scale), bitnet's sub-norm, the output
projection and its bias, post-attention and post-FFN norms
(gemma2/3, grok, glm4; olmo2's and chameleon's swin ordering, which have
no pre-norm), the residual scale on both
branches (granite, minicpm), a SwiGLU or GeGLU FFN or an ungated GELU or
squared-ReLU one,
each product with
its bias where the file has one, in parallel with the attention where the
arch says so (command-r, cohere2, phi2, falcon, gptj, plamo: one shared norm;
falcon-40B: the attention's own attn_norm_2; gptneox: the FFN's own
ffn_norm)) -> final norm -> LM head (tied to the embedding where the file
has no output tensor) and its bias (phi2, gptj, phimoe) -> logit scale
(command-r, minicpm, minicpm3, grok; granite's divisor) and final logit
softcap (gemma2), chameleon's image tokens at -FLT_MAX, with the KV
write deferred to one bulk
write per step. A layer with a router
(``ffn_gate_inp``) takes the MoE FFN instead (top-k routing, softmax or
sigmoid with a selection bias (dots1), sparse products over the selected
experts only, llama4's gate weights on the expert input, and a shared
expert, sigmoid-gated in qwen2moe, plain in deepseek2, deepseek, dots1,
bailingmoe and llama4);
a layer without one the dense FFN (the leading dense layers of deepseek2,
deepseek and dots1). An arctic layer takes both: the dense FFN as the
sequential residual, then the MoE FFN on the rms-normed layer input
(ffn_norm_exps) added on top.
Other architectures and features raise NotImplementedError.

Params are a plain dict of dense tensors and WireTensors (convert.py).
"""

from __future__ import annotations

import torch

from ..ops.attention import (alibi_distances, alibi_slopes, chunked_masks, intra_block_mask,
                             masked_attention, old_cache_mask, swa_ring_mask)
from ..ops.cuda import flash_decode, flash_prefill, flash_q8, qmm_id
from ..ops.linear import qmatmul, qmatmul_multi
from ..ops.norms import layer_norm, rms_norm
from ..ops.rope import apply_rope_tables, rope_tables
from ..quant.wire import WireTensor, dequantize_rows
from ..runtime.kv_cache import KVCache, QuantKVCache, SwaKVCache
from .config import ModelConfig

SUPPORTED_ARCHES = ("llama", "qwen2", "qwen2moe", "qwen3", "qwen3moe", "gemma", "gemma2",
                    "gemma3", "phi3", "command-r", "cohere2", "deepseek2", "phi2", "gpt2",
                    "starcoder", "starcoder2", "falcon", "gptneox", "gptj", "stablelm",
                    "llama4", "olmo", "olmo2", "olmoe", "granite", "granitemoe", "minicpm",
                    "bloom", "mpt", "refact", "jais", "xverse", "baichuan", "internlm2",
                    "exaone", "orion", "codeshell", "qwen", "plamo", "nemotron", "arcee",
                    "deepseek", "dots1", "bailingmoe", "phimoe", "grok", "arctic", "dbrx",
                    "minicpm3", "plm", "glm4", "chatglm", "chameleon", "bitnet", "openelm",
                    "deci")


# the features each admitted family brings: layer norm (Command-R and the
# layer-norm families), the parallel residual (Command-R, phi2, falcon,
# gptneox, gptj), the logit scale (Command-R), cohere2's NoPE global layers,
# learned positions without rope (gpt2, starcoder), MLA (DeepSeek-V2),
# shared experts (Qwen2-MoE, DeepSeek-V2, Llama 4), the non-parametric layer
# norm and clamp_kqv (olmo), post-norm-only layers (olmo2), q/k norms over
# the whole projection (olmo2, olmoe), the residual and logit scales
# (granite, granitemoe, minicpm) and Llama 4's chunked attention, NoPE
# layers with attention temperature, L2 q/k norm and weights before the
# experts; ALiBi without rope (bloom, mpt, refact, jais), mpt's clamp_kqv;
# layer norm (bloom, mpt, jais, orion, codeshell, nemotron) and plamo's
# parallel residual; the MoE variants' ungated shared experts (deepseek,
# dots1, bailingmoe), dbrx's layer norm without a bias and its clamp_kqv,
# and grok's logit scale; MLA with minicpm's scales (minicpm3) and without
# (plm), chameleon's per-head layer norms and swin post-norm-only layers,
# and the per-layer head counts of openelm and deci; another arch that sets
# one is refused by the feature's name
_COHERE_ARCHES = ("command-r", "cohere2")
_LAYER_NORM_ARCHES = (*_COHERE_ARCHES, "phi2", "gpt2", "starcoder", "starcoder2", "falcon",
                      "gptneox", "gptj", "stablelm", "olmo", "bloom", "mpt", "jais", "orion",
                      "codeshell", "nemotron", "dbrx")
_PARALLEL_ARCHES = (*_COHERE_ARCHES, "phi2", "falcon", "gptneox", "gptj", "plamo")
_LEARNED_POS_ARCHES = ("gpt2", "starcoder")
_ALIBI_ARCHES = ("bloom", "mpt", "refact", "jais")
_SHEXP_ARCHES = ("qwen2moe", "deepseek2", "llama4", "deepseek", "dots1", "bailingmoe")
_SCALED_ARCHES = ("granite", "granitemoe", "minicpm", "minicpm3")
_MLA_ARCHES = ("deepseek2", "minicpm3", "plm")
_PER_LAYER_HEAD_ARCHES = ("openelm", "deci")


def check_supported(cfg: ModelConfig) -> None:
    """Raise on anything this slice of the port does not cover: an
    architecture outside SUPPORTED_ARCHES, or a feature flag that only
    other architectures (or metadata keys these do not use) set."""
    if cfg.arch not in SUPPORTED_ARCHES:
        raise NotImplementedError(f"architecture {cfg.arch!r} is not ported yet")
    cohere, llama4 = cfg.arch in _COHERE_ARCHES, cfg.arch == "llama4"
    unsupported = {
        "non-parametric layer norm": cfg.nonparam_norms and cfg.arch != "olmo",
        "layer norm": cfg.norm_type != "rms" and cfg.arch not in _LAYER_NORM_ARCHES,
        "parallel residual": cfg.parallel_residual and cfg.arch not in _PARALLEL_ARCHES,
        "ALiBi": cfg.use_alibi and cfg.arch not in _ALIBI_ARCHES,
        # no rope and no ALiBi: the positions must come from a table
        "learned positions": ((cfg.learned_pos_embd or not (cfg.rope.enabled or cfg.use_alibi))
                              and cfg.arch not in _LEARNED_POS_ARCHES),
        "MLA": (cfg.n_lora_q > 0 or cfg.n_lora_kv > 0) and cfg.arch not in _MLA_ARCHES,
        # the JAX MLA branch writes K of n_head heads into a cache of
        # head_count_kv heads; config.py makes them equal for deepseek2 alone
        "MLA over fewer kv heads than query heads (head_count_kv != head_count)": (
            cfg.arch in ("minicpm3", "plm") and cfg.n_head_kv != cfg.n_head),
        "per-layer head counts": (bool(cfg.n_head_arr or cfg.n_head_kv_arr)
                                  and cfg.arch not in _PER_LAYER_HEAD_ARCHES),
        "M-RoPE": bool(cfg.rope.sections),
        "chunked SWA": cfg.swa_type == "chunked" and not llama4,
        "MoE weights before the experts": cfg.moe_weight_before and not llama4,
        "shared experts": cfg.arch not in _SHEXP_ARCHES and (cfg.n_expert_shared > 0
                                                             or cfg.n_ff_shexp > 0),
        # olmo2's, and chameleon's swin ordering
        "post-norm-only layers": cfg.post_norm_only and cfg.arch not in ("olmo2", "chameleon"),
        "q/k norms over the whole projection or per-head layer norms": (
            (cfg.qk_norm_layer and cfg.arch != "chameleon")
            or (cfg.qk_norm_full and cfg.arch not in ("olmo2", "olmoe"))),
        "NoPE layers and attention temperature": not llama4 and (
            cfg.use_attn_temp or cfg.use_kq_norm or (cfg.n_no_rope_layer_step > 0
                                                     and cfg.arch != "cohere2")),
        # grok multiplies its logits by 0.57735, as command-r does
        "logit scale": (cfg.logit_scale != 1.0 and not cohere and cfg.arch != "grok"
                        and cfg.arch not in _SCALED_ARCHES),
        "residual scale": cfg.residual_scale != 1.0 and cfg.arch not in _SCALED_ARCHES,
        "clamp_kqv": cfg.attn_clamp > 0.0 and cfg.arch not in ("olmo", "mpt", "dbrx"),
        "non-causal attention": not cfg.causal,
        "interleaved MoE layers": cfg.moe_every_n_layers > 0,
    }
    missing = [k for k, v in unsupported.items() if v]
    if missing:
        raise NotImplementedError(f"not ported yet: {', '.join(missing)}")


def _gather_rows(table, ids: torch.Tensor, dtype) -> torch.Tensor:
    if isinstance(table, WireTensor):
        # gather the looked-up rows' blocks first, decode only those — never
        # the whole [V, E] table
        return dequantize_rows(table, ids, torch.float32).to(dtype)
    return table[ids].to(dtype)


def embed_tokens(params: dict, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return _gather_rows(params["tok_embd"], tokens, dtype)


def embed_positions(params: dict, positions: torch.Tensor, dtype) -> torch.Tensor:
    """The learned position rows (gpt2, starcoder), dense or quantized (the
    JAX quantizer does not skip position_embd.weight). A position past the
    table reads its last row: the engine refuses a max_seq past the table
    (runtime/engine.py), so only an inactive full row of a batch, whose
    logits nobody reads, gets there; the JAX package's jnp.take gives that
    row NaN, and a CUDA index past the table would fault the device."""
    table = params["pos_embd"]
    return _gather_rows(table, positions.clamp(max=table.shape[0] - 1), dtype)


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    """The FFN activation in f32: SiLU, ggml_gelu's tanh form (Gemma), or
    the squared ReLU (nemotron, arcee)."""
    xf = x.float()
    if kind == "silu":
        return torch.nn.functional.silu(xf)
    if kind == "gelu":
        return torch.nn.functional.gelu(xf, approximate="tanh")
    if kind == "relu2":  # nemotron, arcee: the squared ReLU
        return torch.square(torch.relu(xf))
    raise NotImplementedError(f"FFN activation {kind!r} is not ported yet")


def _linear(x: torch.Tensor, layer: dict, key: str) -> torch.Tensor:
    """One projection, times its scalar scale (bitnet's `key`_scale) and
    plus its bias (qwen2's q/k/v, the layer-norm families' products), each
    in the activation dtype after the product, as the JAX _linear applies
    them."""
    out = qmatmul(x, layer[key])
    sc = layer.get(key + "_scale")
    if sc is not None:
        out = out * sc.to(out.dtype)
    b = layer.get(key + "_b")
    return out if b is None else out + b.to(out.dtype)


def _linear_multi(x: torch.Tensor, layer: dict, keys) -> list:
    """Same-input projections through ONE kernel launch (mixed kinds OK)
    when none carries a bias or a scale; per-key launches when one does, or
    when a weight cannot ride the shared launch."""
    if not any(k + "_b" in layer or k + "_scale" in layer for k in keys):
        outs = qmatmul_multi(x, [layer[k] for k in keys])
        if outs is not None:
            return outs
    return [_linear(x, layer, k) for k in keys]


def _ffn(layer: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Gated (SwiGLU/GeGLU) or, with no ffn_gate, the plain act(up) -> down
    MLP (the layer-norm families), each product with its bias; bitnet's
    ffn_sub_norm (rms) on the activation before ffn_down."""
    if "ffn_gate_up" in layer:
        gate, up = _linear(x, layer, "ffn_gate_up").chunk(2, dim=-1)
        h = (_act(gate, cfg.ffn_act) * up.float()).to(x.dtype)
    elif "ffn_gate" in layer:
        gate, up = _linear_multi(x, layer, ("ffn_gate", "ffn_up"))
        h = (_act(gate, cfg.ffn_act) * up.float()).to(x.dtype)
    else:
        h = _act(_linear(x, layer, "ffn_up"), cfg.ffn_act).to(x.dtype)
    if "ffn_sub_norm" in layer:
        h = rms_norm(h, layer["ffn_sub_norm"], cfg.rms_norm_eps)
    return _linear(h, layer, "ffn_down")


def _moe_router(layer: dict, x: torch.Tensor, cfg: ModelConfig):
    """Top-k routing (build_moe_ffn): softmax or sigmoid gating, optional
    selection bias, weight norm and scale. x [..., E] -> (top_i [..., k],
    gate_w [..., k] f32), both on x's device."""
    logits = qmatmul(x, layer["ffn_gate_inp"]).float()  # [..., n_exp]
    if cfg.expert_gating_func == "sigmoid":
        probs = torch.sigmoid(logits)
    else:
        probs = torch.softmax(logits, dim=-1)
    sel = probs + layer["exp_probs_b"].float() if "exp_probs_b" in layer else probs
    top_i = torch.topk(sel, cfg.n_expert_used, dim=-1).indices
    gate_w = torch.gather(probs, -1, top_i)  # pre-bias probs
    if cfg.expert_weights_norm:
        gate_w = gate_w / (gate_w.sum(dim=-1, keepdim=True) + 1e-20)
    return top_i, gate_w * cfg.expert_weights_scale


def _matmul_id(rows: torch.Tensor, ids: torch.Tensor, w: WireTensor) -> torch.Tensor:
    """[S, K] rows x per-row expert -> [S, N] f32; reads only the selected
    experts (K10). The JAX package's offset route (K12, behind
    GATHER_OFFSET_MAX) is the same launch here, so it has no setting. The
    JAX package's _matmul_ragged has no counterpart here: its choice of
    route is qmm_id.qmm_ragged's."""
    return qmm_id.qmm_gather(rows, ids, w)


# decode-vs-prefill crossover (in (token, slot) rows) and prefill token tile
# of the sparse MoE paths; row counts follow the step's shape, so the
# choice never looks at routing results
_MOE_GATHER_MAX = 32
_MOE_TILE = qmm_id.RAGGED_TILE


def moe_sort(ids: torch.Tensor, n_exp: int, tt: int):
    """The expert-sorted, per-expert padded row layout of the grouped GEMM
    for the (token, slot) pairs' experts ids [Sp], computed on the device
    with no host sync. Returns (dest [Sp]: each pair's row in the padded
    buffer, in pair order; tile_expert [s_pad // tt] int32: the expert of
    each token tile, n_exp for the padding tiles past the last used
    expert's padded end, which the kernels skip; s_pad: the static row
    bound, a function of Sp alone)."""
    Sp = ids.shape[0]
    ids = ids.long()
    order = torch.argsort(ids, stable=True)
    sids = ids[order]
    counts = torch.zeros(n_exp, dtype=torch.long, device=ids.device).index_add_(
        0, ids, torch.ones_like(ids))
    padded = (counts + tt - 1) // tt * tt
    offs = torch.cumsum(padded, 0) - padded    # padded start of each expert
    starts = torch.cumsum(counts, 0) - counts  # sorted start of each expert
    rank = torch.arange(Sp, device=ids.device) - starts[sids]
    dest = torch.empty_like(sids).index_copy_(0, order, offs[sids] + rank)
    s_pad = (Sp + n_exp * (tt - 1) + tt - 1) // tt * tt
    tile_start = torch.arange(s_pad // tt, device=ids.device) * tt
    tile_expert = torch.searchsorted(offs + padded, tile_start, right=True)
    return dest, tile_expert.to(torch.int32), s_pad


def _ffn_moe_sparse(layer: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Sparse MoE over stacked wire-format experts: only the top-k experts'
    bytes are read. Few rows (decode): per-(token, slot) expert-gathered
    matvecs. Many rows (prefill): rows sorted by expert and padded to
    _MOE_TILE multiples, a grouped GEMM, then back to pair order. Returns
    [B, T, E] f32."""
    B, T, E = x.shape
    n_exp, k = cfg.n_expert, cfg.n_expert_used
    S = B * T
    xf = x.reshape(S, E)
    top_i, gate_w = _moe_router(layer, xf, cfg)  # [S, k]
    Sp = S * k
    ids = top_i.reshape(Sp).to(torch.int32)
    rows = xf.repeat_interleave(k, dim=0)  # [(s, slot)] pair rows
    if cfg.moe_weight_before:  # llama4: the gate weights scale the expert input
        rows = rows * gate_w.reshape(Sp, 1).to(rows.dtype)
    if not all(isinstance(layer[key], WireTensor) for key in
               ("ffn_gate_up_exps", "ffn_gate_exps", "ffn_up_exps", "ffn_down_exps")
               if key in layer):
        raise NotImplementedError("sparse MoE with dense and quantized expert stacks mixed")
    ragged = Sp > _MOE_GATHER_MAX
    if ragged:
        dest, tile_expert, s_pad = moe_sort(ids, n_exp, _MOE_TILE)
        rows = torch.zeros((s_pad, E), dtype=x.dtype, device=x.device).index_copy_(
            0, dest, rows)

    def product(inp, w):
        if ragged:
            return qmm_id.qmm_ragged(inp, tile_expert, w, _MOE_TILE)
        return _matmul_id(inp, ids, w)

    if "ffn_gate_up_exps" in layer:  # fused per-expert [gate; up] rows
        gate, up = product(rows, layer["ffn_gate_up_exps"]).chunk(2, dim=-1)
    else:
        gate, up = product(rows, layer["ffn_gate_exps"]), product(rows, layer["ffn_up_exps"])
    h = (_act(gate, cfg.ffn_act) * up).to(x.dtype)
    down = product(h, layer["ffn_down_exps"])  # [Sp, E] or [s_pad, E] f32
    if ragged:
        down = down.index_select(0, dest)  # back to (s, slot) pair order
    down = down.reshape(S, k, E)
    # with the weights before the experts, the outputs sum unweighted
    out = (down if cfg.moe_weight_before else down * gate_w[..., None]).sum(dim=1)
    return out.reshape(B, T, E)


def _ffn_moe(layer: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """MoE FFN. Wire-format experts take the sparse top-k path; dense
    (f32/f16/bf16) experts the all-expert einsums, as the JAX package; with
    moe_weight_before (llama4) the gate weights scale each expert's input
    (an expert not selected sees zeros) and the outputs sum unweighted. A
    shared expert (qwen2moe, deepseek2, llama4) adds its FFN, times the
    sigmoid of its gate where the layer has one, in f32 before the cast."""
    if isinstance(layer.get("ffn_gate_up_exps", layer.get("ffn_gate_exps")), WireTensor):
        out = _ffn_moe_sparse(layer, x, cfg)
    else:
        top_i, gate_w = _moe_router(layer, x, cfg)  # [B, T, k]
        comb = torch.zeros((*x.shape[:-1], cfg.n_expert), dtype=torch.float32,
                           device=x.device).scatter_add_(-1, top_i, gate_w)
        if cfg.moe_weight_before:
            xin, spec = x[:, :, None, :] * comb[..., None].to(x.dtype), "btne,nfe->btnf"
        else:
            xin, spec = x, "bte,nfe->btnf"
        gate = torch.einsum(spec, xin, layer["ffn_gate_exps"])
        up = torch.einsum(spec, xin, layer["ffn_up_exps"])
        act = _act(gate, cfg.ffn_act).to(x.dtype) * up
        expert_out = torch.einsum("btnf,nef->btne", act, layer["ffn_down_exps"])
        out = (expert_out.float().sum(dim=2) if cfg.moe_weight_before
               else torch.einsum("btne,btn->bte", expert_out.float(), comb))
    if "ffn_up_shexp" in layer:
        shexp = {"ffn_gate": layer["ffn_gate_shexp"], "ffn_up": layer["ffn_up_shexp"],
                 "ffn_down": layer["ffn_down_shexp"]}
        sh = _ffn(shexp, x, cfg).float()
        if "ffn_gate_inp_shexp" in layer:
            sh = sh * torch.sigmoid(qmatmul(x, layer["ffn_gate_inp_shexp"]).float())
        out = out + sh
    return out.to(x.dtype)


def _layer_ffn(layer: dict, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """A layer's FFN: the MoE FFN where the layer has a router (and no
    arctic branch norm: arctic's router belongs to its parallel branch),
    else the dense one (the leading dense layers of deepseek2, deepseek and
    dots1, llama4's interleaved ones, arctic's)."""
    if cfg.n_expert > 0 and "ffn_gate_inp" in layer and "ffn_norm_exps" not in layer:
        return _ffn_moe(layer, h, cfg)
    return _ffn(layer, h, cfg)


def _scale_in(x: torch.Tensor, value: float) -> torch.Tensor:
    """x * value with value rounded to x's dtype first, as the JAX package
    multiplies by jnp.asarray(value, dtype): a Python scalar, so the step
    copies nothing from the host."""
    return x * float(torch.tensor(value, dtype=x.dtype))


def _norm(x: torch.Tensor, tensors: dict, key: str, cfg: ModelConfig) -> torch.Tensor:
    """The arch's norm with weight `key` (and its bias `key`_b where the
    file has one): layer norm (command-r, cohere2, the layer-norm families;
    olmo's has neither tensor: the non-parametric norm) or rms norm."""
    if cfg.norm_type == "layer":
        return layer_norm(x, tensors.get(key), tensors.get(key + "_b"), cfg.norm_eps)
    return rms_norm(x, tensors[key], cfg.rms_norm_eps, tensors.get(key + "_b"))


def rope_factors(params: dict, cfg: ModelConfig, max_seq: int):
    """The per-dim rope frequency divisors (llama_model::get_rope_factors,
    the JAX _rope_factors): rope_freqs where the file has it, else phi3's
    long factors when the cache reaches past the original context, its
    short ones otherwise. The forward and the context shift both take
    them, so a shifted key is rotated by the table that made it."""
    if "rope_freqs" in params:
        return params["rope_freqs"]
    if "rope_long" in params or "rope_short" in params:
        if cfg.rope.orig_ctx_len and max_seq > cfg.rope.orig_ctx_len:
            return params.get("rope_long", params.get("rope_short"))
        return params.get("rope_short", params.get("rope_long"))
    return None


def _mla_qkv(layer: dict, h: torch.Tensor, cfg: ModelConfig, tab):
    """deepseek2's MLA in the decompressed-MHA form (the JAX forward's
    branch, llama.py:571-604): q from attn_q, or from the q LoRA (attn_q_a,
    its rms norm, attn_q_b_proj); the compressed kv and the shared rope key
    from attn_kv_a_mqa (one launch with q's first product); rope on the
    rope parts only; the compressed kv's rms norm decompressed by attn_kv_b
    into each head's nope key and value. q and k put the rope part first,
    the JAX cache's layout. Returns q, k [B, T, H, Dk] and v [B, T, H, Dv]."""
    B, T = h.shape[:2]
    H, Dk, Dv = cfg.n_head, cfg.head_dim_k, cfg.head_dim_v
    rdim, eps = cfg.rope.dim, cfg.rms_norm_eps
    nope = Dk - rdim
    q_in = "attn_q_a" if "attn_q_a" in layer else "attn_q"
    q, kv_pe = _linear_multi(h, layer, (q_in, "attn_kv_a_mqa"))
    if q_in == "attn_q_a":
        q = qmatmul(rms_norm(q, layer["attn_q_a_norm"], eps), layer["attn_q_b_proj"])
    q = q.reshape(B, T, H, Dk)
    q_pe = apply_rope_tables(q[..., nope:], tab, rdim, interleaved=cfg.rope.interleaved)
    k_pe = apply_rope_tables(kv_pe[..., cfg.n_lora_kv:].reshape(B, T, 1, rdim), tab, rdim,
                             interleaved=cfg.rope.interleaved)
    kv_cmpr = rms_norm(kv_pe[..., :cfg.n_lora_kv], layer["attn_kv_a_norm"], eps)
    kv = qmatmul(kv_cmpr, layer["attn_kv_b"]).reshape(B, T, H, nope + Dv)
    q = torch.cat([q_pe, q[..., :nope]], dim=-1)
    k = torch.cat([k_pe.expand(B, T, H, rdim), kv[..., :nope]], dim=-1)
    return q, k, kv[..., nope:].contiguous()


def forward(
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,     # [B, T] int64
    positions: torch.Tensor,  # [B, T] absolute positions
    cache: KVCache | QuantKVCache | SwaKVCache,
    write_pos: torch.Tensor,  # [B] int32 cache write offsets (= valid old length)
    dtype=torch.bfloat16,
    logits_last=None,         # host ints [B]: compute the LM head only there
    kv_cap: int | None = None,  # bound on the attended cache prefix
    write_mask: torch.Tensor | None = None,  # [B] bool on the device: rows whose K/V land
    n_new: torch.Tensor | None = None,  # [B] int32 on the device: real tokens of the block
) -> tuple[torch.Tensor, KVCache | QuantKVCache | SwaKVCache]:
    """Returns (logits [B, T, V] f32 — [B, 1, V] with logits_last — and the
    cache, updated in place). Layers read the old cache and attend to the
    current block explicitly; one bulk write lands all layers' K/V, in the
    rows of write_mask only when it is given (a row that is not active
    writes nothing). The cache may be a one-row view of a larger cache
    (KVCache.row): the write lands there in place. On a ring cache
    (SwaKVCache) the sliding-window layers read their ring through the
    masked attention with the ring mask, the JAX forward's route for a ring
    (models/llama.py:320-329), and the global layers read the full store
    through the flash kernels; `n_new` keeps a padded prefill's pads out of
    the ring."""
    B, T = tokens.shape
    H, Hkv = cfg.n_head, cfg.n_head_kv
    Dk, Dv = cfg.head_dim_k, cfg.head_dim_v
    scale = cfg.kq_scale
    if kv_cap is not None and kv_cap >= cache.max_seq:
        kv_cap = None
    ring = isinstance(cache, SwaKVCache)
    flat = cache.full if ring else cache  # the store the flash routes read
    # decode routes of the JAX forward (models/llama.py:444-452): stacked by
    # default; with LLAMACOG_FLASH_STACKED=0 per layer — a quantized cache
    # to K8, the dense one to K9 when LLAMACOG_FLASH_DECODE=1, else masked
    use_stacked = flash_q8.stacked_decode_supported(cfg, flat, T)
    use_q8 = not use_stacked and flash_q8.decode_supported(cfg, flat, T)
    use_flash = flash_decode.supported(cfg, flat, T)
    # a block over a quantized cache: K7, or the masked path over the
    # dequantized planes where 32 does not divide the head dim (Phi-2); over
    # the dense store K5
    use_q8_prefill = flash_q8.prefill_supported(cfg, flat)
    use_dense_prefill = flash_prefill.supported(cfg, flat)
    if ring:
        ring_ok = swa_ring_mask(write_pos, T, cache.window, cfg.sliding_window)
        ring_cur = intra_block_mask(T, cfg.sliding_window, device=tokens.device)
    # Llama 4, the ALiBi families and the per-layer head counts (openelm,
    # deci): every layer attends through the masked path (the JAX route:
    # every flash route is off for a chunked, an ALiBi or a per-layer-head
    # model); Llama 4's chunked layers within their chunk, the others over
    # the whole causal past; ALiBi adds each head's slope times the
    # distance, all built on the device from write_pos
    masked = flash_q8.masked_only(cfg)
    if masked:
        s_att = kv_cap if kv_cap is not None else flat.max_seq
        full_ok = (old_cache_mask(write_pos, T, s_att), intra_block_mask(T, device=tokens.device))
        chunk_ok = (chunked_masks(write_pos, T, s_att, cfg.sliding_window)
                    if cfg.swa_type == "chunked" else full_ok)
        alibi = ((alibi_slopes(H, cfg.max_alibi_bias, tokens.device),
                  *alibi_distances(write_pos, T, s_att)) if cfg.use_alibi else None)

    def _old(il):
        k_old, v_old = flat.read(il)
        if kv_cap is not None:
            k_old, v_old = k_old[:, :kv_cap], v_old[:, :kv_cap]
        return k_old, v_old

    def _attend(q, k, v, il, is_swa):
        win = cfg.sliding_window if is_swa else 0
        softcap = cfg.attn_logit_softcap
        if masked:
            k_old, v_old = _old(il)
            if k.shape[2] != Hkv:  # per-layer kv heads: the layer's own first heads
                k_old, v_old = k_old[:, :, :k.shape[2]], v_old[:, :, :k.shape[2]]
            return masked_attention(q, k_old, v_old, k, v, *(chunk_ok if is_swa else full_ok),
                                    scale, logit_softcap=softcap, alibi=alibi)
        if ring:
            is_ring, il = cache.index(il)
            if is_ring:
                k_old, v_old = cache.read_ring(il)
                return masked_attention(q, k_old, v_old, k, v, ring_ok, ring_cur, scale,
                                        logit_softcap=softcap)
        if use_stacked:
            return flash_q8.decode_from_cache(
                q[:, 0], flat, il, k[:, 0], v[:, 0], write_pos, scale,
                softcap=softcap, window=win, kv_cap=kv_cap)[:, None]
        if use_q8:
            return flash_q8.flash_decode_q8_auto(
                q[:, 0], tuple(p[il] for p in flat.k_planes),
                tuple(p[il] for p in flat.v_planes), k[:, 0], v[:, 0], write_pos, scale,
                softcap=softcap, window=win, kv_cap=kv_cap, kinds=flat.kinds)[:, None]
        if T > 1 and use_q8_prefill:
            return flash_q8.flash_prefill_q8(
                q, tuple(p[il] for p in flat.k_planes), tuple(p[il] for p in flat.v_planes),
                k, v, write_pos, scale, softcap=softcap, window=win,
                kv_cap=kv_cap, kinds=flat.kinds)
        k_old, v_old = _old(il)
        if T == 1 and use_flash:
            return flash_decode.flash_decode_attention(
                q[:, 0], k_old, v_old, k[:, 0], v[:, 0], write_pos, scale,
                softcap=softcap, window=win)[:, None]
        if T > 1 and use_dense_prefill:
            return flash_prefill.flash_prefill_attention(
                q, k_old, v_old, k, v, write_pos, scale, softcap=softcap, window=win)
        # the T=1 step with no flash route, and a quantized cache at a head
        # dim that 32 does not divide
        return masked_attention(q, k_old, v_old, k, v,
                                old_cache_mask(write_pos, T, k_old.shape[1], win),
                                intra_block_mask(T, win, device=q.device), scale,
                                logit_softcap=softcap)

    x = embed_tokens(params, tokens, dtype)
    if cfg.embd_scale != 1.0:  # Gemma: sqrt(n_embd), multiplied in the activation dtype
        x = _scale_in(x, cfg.embd_scale)
    if cfg.learned_pos_embd and "pos_embd" in params:  # gpt2, starcoder
        x = x + embed_positions(params, positions, dtype)
    if "tok_norm" in params:  # bloom: the embedding's layer norm
        x = layer_norm(x, params["tok_norm"], params.get("tok_norm_b"), cfg.norm_eps)
    # llama-3.1 style per-dim rope factors, phi3's long or short ones
    # (rope_factors); gemma3's local layers take a rope of their own (base
    # 10000, no scaling); no rope at all where the arch has none (gpt2,
    # starcoder)
    freq_factors = rope_factors(params, cfg, cache.max_seq)
    rtab = rope_tables(positions, cfg.rope, Dk, freq_factors) if cfg.rope.enabled else None
    rtab_swa = (rope_tables(positions, cfg.rope_swa, Dk, freq_factors)
                if rtab is not None and cfg.rope_freq_base_swa > 0.0 else rtab)
    rdim = cfg.rope.dim or Dk
    eps = cfg.rms_norm_eps
    if cfg.use_attn_temp:
        # llama4's NoPE layers scale q by log(floor((p + 1) / floor_scale) + 1)
        # * scale + 1 (build_inp_attn_scale), in f32, then in q's dtype
        attn_temp = (torch.log(torch.floor((positions.float() + 1.0)
                                           / cfg.n_attn_temp_floor_scale) + 1.0)
                     * cfg.f_attn_temp_scale + 1.0)[:, :, None, None]
    new_ks, new_vs = [], []
    for il, layer in enumerate(params["layers"]):
        x_in = x  # the layer input, which arctic's parallel MoE branch reads
        attn_free = not any(kk in layer for kk in ("attn_qkv", "attn_qk", "attn_q",
                                                    "attn_kv_a_mqa"))
        if attn_free and "attn_norm" not in layer and not cfg.post_norm_only:
            # the JAX forward norms every layer's input before it looks at
            # the layer's kind, so such a layer raises there too
            raise NotImplementedError(f"layer {il}: an attention-free layer without "
                                      "attn_norm is not ported yet")
        # olmo2's and chameleon's post-norm-only layers: the attention reads
        # the raw residual
        h = x if cfg.post_norm_only else _norm(x, layer, "attn_norm", cfg)
        # parallel residual: the FFN reads the same normed input (command-r,
        # cohere2, phi2, falcon-7B, gptj); falcon-40B's attention reads its
        # own attn_norm_2 and the FFN attn_norm; gptneox's FFN its own ffn_norm
        par_ffn_h = h
        if cfg.parallel_residual:
            if "attn_norm_2" in layer:
                h = _norm(x, layer, "attn_norm_2", cfg)
            elif "ffn_norm" in layer:
                par_ffn_h = _norm(x, layer, "ffn_norm", cfg)
        is_swa = cfg.is_swa(il)
        tab = rtab_swa if is_swa else rtab
        if "attn_kv_a_mqa" in layer:
            # MLA (deepseek2, minicpm3, plm): the JAX branch ends its layer
            # itself (llama.py:571-618): no residual scale on either branch
            # (minicpm3's 1.4 / sqrt(n_layer) does not apply), the post norm
            # where the layer has one, then ffn_norm and the dense or the MoE
            # FFN
            q, k, v = _mla_qkv(layer, h, cfg, tab)
            new_ks.append(k)
            new_vs.append(v)
            attn = _attend(q.contiguous(), k, v, il, is_swa)
            attn = _linear(attn.reshape(B, T, H * Dv), layer, "attn_output")
            if cfg.post_norms and "attn_post_norm" in layer:
                attn = _norm(attn, layer, "attn_post_norm", cfg)
            x = x + attn
            x = x + _layer_ffn(layer, _norm(x, layer, "ffn_norm", cfg), cfg)
            continue
        if attn_free:
            # deci's layer kinds (llama.py:619-635): the cache's rows still
            # take zero K/V; a "linear attention" layer (attn_output alone)
            # adds attn_output(attn_norm(x)); an FFN-free layer ends here
            new_ks.append(torch.zeros((B, T, Hkv, Dk), dtype=x.dtype, device=x.device))
            new_vs.append(torch.zeros((B, T, Hkv, Dv), dtype=x.dtype, device=x.device))
            if "attn_output" in layer:
                x = x + _linear(_norm(x, layer, "attn_norm", cfg), layer, "attn_output")
            if not any(kk in layer for kk in ("ffn_gate_up", "ffn_up", "ffn_gate_inp")):
                continue
            h = _norm(x, layer, "ffn_norm", cfg) if "ffn_norm" in layer else x
            x = x + _layer_ffn(layer, h, cfg)
            continue
        # openelm's and deci's per-layer head counts: a fused projection
        # splits by the layer's own heads
        h_l, hkv_l = cfg.n_head_at(il), cfg.n_head_kv_at(il)
        if "attn_qkv" in layer:
            qkv = _linear(h, layer, "attn_qkv")
            q, k, v = qkv.split([h_l * Dk, hkv_l * Dk, hkv_l * Dv], dim=-1)
        elif "attn_qk" in layer:
            # q+k fused when v's quant kind differs; qk and v ride ONE launch
            qk, v = _linear_multi(h, layer, ("attn_qk", "attn_v"))
            q, k = qk.split([h_l * Dk, qk.shape[-1] - h_l * Dk], dim=-1)
        else:
            q, k, v = _linear_multi(h, layer, ("attn_q", "attn_k", "attn_v"))
            if cfg.qk_norm_full and "attn_q_norm" in layer:
                # olmo2, olmoe: one rms norm over the whole projection
                q = rms_norm(q, layer["attn_q_norm"], eps)
                k = rms_norm(k, layer["attn_k_norm"], eps)
        # by the weights' rows, never n_embd: Qwen3-30B-A3B's q is 4096 wide
        # over an n_embd of 2048
        q = q.reshape(B, T, -1, Dk)
        k = k.reshape(B, T, -1, Dk)
        v = v.reshape(B, T, -1, Dv)
        if cfg.attn_clamp > 0.0:  # olmo's and mpt's clamp_kqv
            c = cfg.attn_clamp
            q, k, v = q.clamp(-c, c), k.clamp(-c, c), v.clamp(-c, c)
        v = v.contiguous()
        if cfg.qk_norm_layer and "attn_q_norm" in layer:
            # chameleon: a layer norm of each head with [heads, head_dim]
            # weights and biases, before rope, at cfg.norm_eps (0: the
            # reference reads no eps for it)
            q = layer_norm(q, layer["attn_q_norm"], layer.get("attn_q_norm_b"), cfg.norm_eps)
            k = layer_norm(k, layer["attn_k_norm"], layer.get("attn_k_norm_b"), cfg.norm_eps)
        elif "attn_q_norm" in layer and not cfg.qk_norm_full:
            # qwen3, gemma3, command-r-plus, openelm: per-head rms norm
            q = rms_norm(q, layer["attn_q_norm"], eps)
            k = rms_norm(k, layer["attn_k_norm"], eps)
        # the NoPE layers (every n_no_rope_layer_step-th) take no rope:
        # cohere2's global layers, and llama4's, whose q takes the
        # position temperature instead; llama4's roped layers normalize
        # q and k after the rope (the weightless L2 norm)
        nope = cfg.n_no_rope_layer_step > 0 and (il + 1) % cfg.n_no_rope_layer_step == 0
        if tab is not None and not nope:
            q = apply_rope_tables(q, tab, rdim, interleaved=cfg.rope.interleaved)
            k = apply_rope_tables(k, tab, rdim, interleaved=cfg.rope.interleaved)
            if cfg.use_kq_norm:
                q, k = rms_norm(q, None, eps), rms_norm(k, None, eps)
        elif nope and cfg.use_attn_temp:
            q = q * attn_temp.to(q.dtype)
        k = k.contiguous()
        # a layer with fewer kv heads than the cache's writes its K/V padded
        # with zero heads; it attends its own heads alone
        pad = (0, 0, 0, Hkv - k.shape[2])
        new_ks.append(torch.nn.functional.pad(k, pad) if pad[-1] else k)
        new_vs.append(torch.nn.functional.pad(v, pad) if pad[-1] else v)
        attn = _attend(q.contiguous(), k, v, il, is_swa)
        # flattened by the layer's own heads (openelm, deci)
        attn = attn.reshape(B, T, attn.shape[2] * Dv)
        if "attn_sub_norm" in layer:  # bitnet: rms norm before attn_output
            attn = rms_norm(attn, layer["attn_sub_norm"], eps)
        attn = _linear(attn, layer, "attn_output")
        if cfg.post_norms and "attn_post_norm" in layer:
            attn = _norm(attn, layer, "attn_post_norm", cfg)
        if cfg.residual_scale != 1.0:  # granite, minicpm: both branches scaled
            attn = _scale_in(attn, cfg.residual_scale)
        if cfg.parallel_residual:
            x = x + attn + _ffn(layer, par_ffn_h, cfg)
            continue
        x = x + attn
        # olmo's FFN norm has no tensor: the non-parametric norm
        h = _norm(x, layer, "ffn_norm", cfg) if "ffn_norm" in layer or cfg.nonparam_norms else x
        ffn = _layer_ffn(layer, h, cfg)
        if cfg.post_norms and "ffn_post_norm" in layer:
            ffn = _norm(ffn, layer, "ffn_post_norm", cfg)
        if cfg.residual_scale != 1.0:
            ffn = _scale_in(ffn, cfg.residual_scale)
        x = x + ffn
        if "ffn_norm_exps" in layer:
            # arctic: the dense FFN above is sequential; the MoE branch reads
            # the rms-normed layer input, and its output adds on top
            x = x + _ffn_moe(layer, rms_norm(x_in, layer["ffn_norm_exps"], eps), cfg)

    cache = cache.write_all(torch.stack(new_ks), torch.stack(new_vs), write_pos,
                            active=write_mask, n_new=n_new)
    if logits_last is not None:
        idx = torch.as_tensor(logits_last, device=x.device).long().reshape(B, 1, 1)
        x = torch.gather(x, 1, idx.expand(B, 1, x.shape[-1]))
    x = _norm(x, params, "output_norm", cfg)
    out_w = params.get("output", params["tok_embd"])  # tied: the embedding table
    # f32 kernel output, rounded to the activation dtype, then f32 logits
    logits = qmatmul(x, out_w).float()
    if "output_b" in params:  # phi2, gptj
        logits = logits + params["output_b"].float()
    if cfg.logit_scale != 1.0:  # command-r, minicpm; granite's divisor as its inverse
        # (config.py: _apply_arch_defaults)
        logits = logits * cfg.logit_scale
    if cfg.final_logit_softcap > 0.0:  # gemma2
        c = cfg.final_logit_softcap
        logits = c * torch.tanh(logits / c)
    if cfg.arch == "chameleon" and cfg.n_vocab > 8196:
        # text-only output: the image tokens [4, 8196) get -FLT_MAX, filled
        # on the device (the decode graph captures it)
        logits[..., 4:8196] = -3.4028234663852886e38
    return logits, cache
