"""Llama transformer forward pass (PyTorch).

Counterpart of the llama branches of llamacog_tpu/models/llama.py::forward:
embedding -> per layer (rms norm, fused q/k/v projections, rope, attention
over the old cache plus the current block, output projection, SwiGLU FFN)
-> final norm -> LM head, with the KV write deferred to one bulk write per
step. Other architectures and features raise NotImplementedError.

Params are a plain dict of dense tensors and WireTensors (convert.py).
"""

from __future__ import annotations

import torch

from ..ops.cuda import flash_prefill, flash_q8
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
        "MoE": cfg.n_expert > 0,
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
) -> tuple[torch.Tensor, KVCache | QuantKVCache]:
    """Returns (logits [B, T, V] f32 — [B, 1, V] with logits_last — and the
    cache, updated in place). Layers read the old cache and attend to the
    current block explicitly; one bulk write lands all layers' K/V."""
    B, T = tokens.shape
    H, Hkv = cfg.n_head, cfg.n_head_kv
    Dk, Dv = cfg.head_dim_k, cfg.head_dim_v
    scale = cfg.kq_scale
    if kv_cap is not None and kv_cap >= cache.max_seq:
        kv_cap = None

    def _attend(q, k, v, il, is_swa):
        win = cfg.sliding_window if is_swa else 0
        if T == 1:
            return flash_q8.decode_from_cache(
                q[:, 0], cache, il, k[:, 0], v[:, 0], write_pos, scale,
                softcap=cfg.attn_logit_softcap, window=win, kv_cap=kv_cap)[:, None]
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
        x = x + _ffn(layer, h)

    cache = cache.write_all(torch.stack(new_ks), torch.stack(new_vs), write_pos)
    if logits_last is not None:
        idx = torch.as_tensor(logits_last, device=x.device).long().reshape(B, 1, 1)
        x = torch.gather(x, 1, idx.expand(B, 1, x.shape[-1]))
    x = rms_norm(x, params["output_norm"], cfg.rms_norm_eps)
    out_w = params.get("output", params["tok_embd"])
    # f32 kernel output, rounded to the activation dtype, then f32 logits
    logits = qmatmul(x, out_w).float()
    return logits, cache
