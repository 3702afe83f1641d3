"""Llama transformer forward pass (PyTorch).

Counterpart of the llama branches of llamacog_tpu/models/llama.py::forward:
embedding -> per layer (rms norm, fused q/k/v projections, rope, attention
over the old cache plus the current block, output projection, SwiGLU FFN)
-> final norm -> LM head, with the KV write deferred to one bulk write per
step. A layer with a router (``ffn_gate_inp``) takes the MoE FFN instead
(Mixtral: top-k routing, sparse products over the selected experts only).
Other architectures and features raise NotImplementedError.

Params are a plain dict of dense tensors and WireTensors (convert.py).
"""

from __future__ import annotations

import torch

from ..ops.attention import intra_block_mask, masked_attention, old_cache_mask
from ..ops.cuda import flash_decode, flash_prefill, flash_q8, qmm_id
from ..ops.linear import qmatmul, qmatmul_multi
from ..ops.norms import rms_norm
from ..ops.rope import apply_rope_tables, rope_tables
from ..quant.wire import WireTensor, dequantize_rows
from ..runtime.kv_cache import KVCache, QuantKVCache
from .config import ModelConfig

SUPPORTED_ARCHES = ("llama",)


def check_supported(cfg: ModelConfig) -> None:
    """Raise on anything this slice of the port does not cover. (The other
    feature flags of ModelConfig are set only by other architectures.)"""
    if cfg.arch not in SUPPORTED_ARCHES:
        raise NotImplementedError(f"architecture {cfg.arch!r} is not ported yet")
    unsupported = {
        "shared experts": cfg.n_expert_shared > 0 or cfg.n_ff_shexp > 0,
        "MoE weights before the experts": cfg.moe_weight_before,
        "per-layer head counts": bool(cfg.n_head_arr or cfg.n_head_kv_arr),
        "M-RoPE": bool(cfg.rope.sections),
    }
    missing = [k for k, v in unsupported.items() if v]
    if missing:
        raise NotImplementedError(f"not ported yet: {', '.join(missing)}")


def embed_tokens(params: dict, tokens: torch.Tensor, dtype) -> torch.Tensor:
    emb = params["tok_embd"]
    if isinstance(emb, WireTensor):
        # gather the looked-up rows' blocks first, decode only those — never
        # the whole [V, E] table
        return dequantize_rows(emb, tokens, torch.float32).to(dtype)
    return emb[tokens].to(dtype)


def _linear_multi(x: torch.Tensor, layer: dict, keys) -> list:
    """Same-input projections through ONE kernel launch (mixed kinds OK);
    per-key launches when a weight cannot ride it."""
    outs = qmatmul_multi(x, [layer[k] for k in keys])
    if outs is not None:
        return outs
    return [qmatmul(x, layer[k]) for k in keys]


def _ffn(layer: dict, x: torch.Tensor) -> torch.Tensor:
    if "ffn_gate_up" in layer:
        gate, up = qmatmul(x, layer["ffn_gate_up"]).chunk(2, dim=-1)
    else:
        gate, up = _linear_multi(x, layer, ("ffn_gate", "ffn_up"))
    h = (torch.nn.functional.silu(gate.float()) * up.float()).to(x.dtype)
    return qmatmul(h, layer["ffn_down"])


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
    h = (torch.nn.functional.silu(gate) * up).to(x.dtype)
    down = product(h, layer["ffn_down_exps"])  # [Sp, E] or [s_pad, E] f32
    if ragged:
        down = down.index_select(0, dest)  # back to (s, slot) pair order
    out = (down.reshape(S, k, E) * gate_w[..., None]).sum(dim=1)
    return out.reshape(B, T, E)


def _ffn_moe(layer: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """MoE FFN. Wire-format experts take the sparse top-k path; dense
    (f32/f16/bf16) experts the all-expert einsums, as the JAX package."""
    if isinstance(layer.get("ffn_gate_up_exps", layer.get("ffn_gate_exps")), WireTensor):
        out = _ffn_moe_sparse(layer, x, cfg)
    else:
        top_i, gate_w = _moe_router(layer, x, cfg)  # [B, T, k]
        comb = torch.zeros((*x.shape[:-1], cfg.n_expert), dtype=torch.float32,
                           device=x.device).scatter_add_(-1, top_i, gate_w)
        gate = torch.einsum("bte,nfe->btnf", x, layer["ffn_gate_exps"])
        up = torch.einsum("bte,nfe->btnf", x, layer["ffn_up_exps"])
        act = torch.nn.functional.silu(gate.float()).to(x.dtype) * up
        expert_out = torch.einsum("btnf,nef->btne", act, layer["ffn_down_exps"])
        out = torch.einsum("btne,btn->bte", expert_out.float(), comb)
    return out.to(x.dtype)


def forward(
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,     # [B, T] int64
    positions: torch.Tensor,  # [B, T] absolute positions
    cache: KVCache | QuantKVCache,
    write_pos: torch.Tensor,  # [B] int32 cache write offsets (= valid old length)
    dtype=torch.bfloat16,
    logits_last=None,         # host ints [B]: compute the LM head only there
    kv_cap: int | None = None,  # bound on the attended cache prefix
    write_mask: torch.Tensor | None = None,  # [B] bool on the device: rows whose K/V land
) -> tuple[torch.Tensor, KVCache | QuantKVCache]:
    """Returns (logits [B, T, V] f32 — [B, 1, V] with logits_last — and the
    cache, updated in place). Layers read the old cache and attend to the
    current block explicitly; one bulk write lands all layers' K/V, in the
    rows of write_mask only when it is given (a row that is not active
    writes nothing). The cache may be a one-row view of a larger cache
    (KVCache.row): the write lands there in place."""
    B, T = tokens.shape
    H, Hkv = cfg.n_head, cfg.n_head_kv
    Dk, Dv = cfg.head_dim_k, cfg.head_dim_v
    scale = cfg.kq_scale
    if kv_cap is not None and kv_cap >= cache.max_seq:
        kv_cap = None
    # decode routes of the JAX forward (models/llama.py:444-452): stacked by
    # default; with LLAMACOG_FLASH_STACKED=0 per layer — a quantized cache
    # to K8, the dense one to K9 when LLAMACOG_FLASH_DECODE=1, else masked
    use_stacked = flash_q8.stacked_decode_supported(T)
    use_q8 = not use_stacked and flash_q8.decode_supported(cache, T)
    use_flash = flash_decode.supported(cfg, cache, T)

    def _attend(q, k, v, il, is_swa):
        win = cfg.sliding_window if is_swa else 0
        softcap = cfg.attn_logit_softcap
        if use_stacked:
            return flash_q8.decode_from_cache(
                q[:, 0], cache, il, k[:, 0], v[:, 0], write_pos, scale,
                softcap=softcap, window=win, kv_cap=kv_cap)[:, None]
        if use_q8:
            return flash_q8.flash_decode_q8_auto(
                q[:, 0], tuple(p[il] for p in cache.k_planes),
                tuple(p[il] for p in cache.v_planes), k[:, 0], v[:, 0], write_pos, scale,
                softcap=softcap, window=win, kv_cap=kv_cap, kinds=cache.kinds)[:, None]
        if T == 1:
            k_old, v_old = cache.read(il)
            if kv_cap is not None:
                k_old, v_old = k_old[:, :kv_cap], v_old[:, :kv_cap]
            if use_flash:
                return flash_decode.flash_decode_attention(
                    q[:, 0], k_old, v_old, k[:, 0], v[:, 0], write_pos, scale,
                    softcap=softcap, window=win)[:, None]
            return masked_attention(q, k_old, v_old, k, v,
                                    old_cache_mask(write_pos, 1, k_old.shape[1], win),
                                    intra_block_mask(1, win, device=q.device), scale,
                                    logit_softcap=softcap)
        if isinstance(cache, QuantKVCache):
            return flash_q8.flash_prefill_q8(
                q, tuple(p[il] for p in cache.k_planes), tuple(p[il] for p in cache.v_planes),
                k, v, write_pos, scale, softcap=cfg.attn_logit_softcap, window=win,
                kv_cap=kv_cap, kinds=cache.kinds)
        k_old, v_old = cache.read(il)
        if kv_cap is not None:
            k_old, v_old = k_old[:, :kv_cap], v_old[:, :kv_cap]
        return flash_prefill.flash_prefill_attention(
            q, k_old, v_old, k, v, write_pos, scale, softcap=cfg.attn_logit_softcap,
            window=win)

    x = embed_tokens(params, tokens, dtype)
    # llama-3.1 style per-dim rope factors (llama_model::get_rope_factors)
    rtab = rope_tables(positions, cfg.rope, Dk, params.get("rope_freqs"))
    rdim = cfg.rope.dim or Dk
    new_ks, new_vs = [], []
    for il, layer in enumerate(params["layers"]):
        if not any(kk in layer for kk in ("attn_qkv", "attn_qk", "attn_q")):
            raise NotImplementedError("attention-free layers are not ported yet")
        h = rms_norm(x, layer["attn_norm"], cfg.rms_norm_eps)
        if "attn_qkv" in layer:
            qkv = qmatmul(h, layer["attn_qkv"])
            q, k, v = qkv.split([H * Dk, Hkv * Dk, Hkv * Dv], dim=-1)
        elif "attn_qk" in layer:
            # q+k fused when v's quant kind differs; qk and v ride ONE launch
            qk, v = _linear_multi(h, layer, ("attn_qk", "attn_v"))
            q, k = qk.split([H * Dk, Hkv * Dk], dim=-1)
        else:
            q, k, v = _linear_multi(h, layer, ("attn_q", "attn_k", "attn_v"))
        q = q.reshape(B, T, H, Dk)
        k = k.reshape(B, T, Hkv, Dk)
        v = v.reshape(B, T, Hkv, Dv)
        q = apply_rope_tables(q, rtab, rdim, interleaved=cfg.rope.interleaved)
        k = apply_rope_tables(k, rtab, rdim, interleaved=cfg.rope.interleaved).contiguous()
        v = v.contiguous()
        new_ks.append(k)
        new_vs.append(v)
        attn = _attend(q.contiguous(), k, v, il, cfg.is_swa(il))
        attn = qmatmul(attn.reshape(B, T, H * Dv), layer["attn_output"])
        x = x + attn
        h = rms_norm(x, layer["ffn_norm"], cfg.rms_norm_eps)
        if cfg.n_expert > 0 and "ffn_gate_inp" in layer:
            x = x + _ffn_moe(layer, h, cfg)
        else:
            x = x + _ffn(layer, h)

    cache = cache.write_all(torch.stack(new_ks), torch.stack(new_vs), write_pos,
                            active=write_mask)
    if logits_last is not None:
        idx = torch.as_tensor(logits_last, device=x.device).long().reshape(B, 1, 1)
        x = torch.gather(x, 1, idx.expand(B, 1, x.shape[-1]))
    x = rms_norm(x, params["output_norm"], cfg.rms_norm_eps)
    out_w = params.get("output", params["tok_embd"])
    # f32 kernel output, rounded to the activation dtype, then f32 logits
    logits = qmatmul(x, out_w).float()
    return logits, cache
