"""Per-layer dense decode attention: kernel K9 and its plain version.

Counterpart of llamacog_tpu/ops/pallas/flash_decode.py, the opt-in decode
route ``LLAMACOG_FLASH_STACKED=0 LLAMACOG_FLASH_DECODE=1``: T = 1 queries
q [B, H, Dk] over one layer's old cache k/v [B, S, Hkv, D] (already cut to
kv_cap by the caller), each row masked to its seq_len and the sliding
window, softcap, and the current token's k/v_cur [B, Hkv, D] folded in.

On one layer this is the function of the stacked decode kernel (K4) at
L = 1, so the kernel is csrc/flash_decode_dense.cu (split-S, with its
combine launch) launched on the layer tensor as a one-layer stack, read in
place by stride (a kv_cap slice of the stacked cache needs no copy). It
counts its launches under its own name, ``flash_decode``, so a run shows
which route ran.
"""

from __future__ import annotations

import os

from ...runtime.kv_cache import KVCache
from . import build
from .flash_q8 import check_dense_q, flash_decode_stacked_dense_plain, launch_dense_decode


def flash_decode_attention_plain(q, k, v, k_cur, v_cur, seq_len, scale, softcap=0.0, window=0):
    """q [B, H, Dk] -> [B, H, Dv]: explicit softmax over the old slots below
    seq_len (within the window) plus the current token."""
    return flash_decode_stacked_dense_plain(q, k[None], v[None], 0, k_cur, v_cur, seq_len,
                                            scale, softcap=softcap, window=window)


def _positions_stride(name, t, B, Hkv, D, dt, dev) -> int:
    """Validate one layer's cache view [B, S, Hkv, D]: contiguous positions,
    heads and dims, any batch stride that is a whole number of positions.
    Returns that number (the S the kernel strides rows by)."""
    if t.dim() != 4 or t.shape[0] != B or tuple(t.shape[2:]) != (Hkv, D) or t.dtype != dt \
            or t.device != dev:
        raise ValueError(f"flash_decode: {name} must be {dt} [B, S, {Hkv}, {D}] on {dev}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    row = Hkv * D
    if t.stride(3) != 1 or t.stride(2) != D or t.stride(1) != row or t.data_ptr() % 16:
        raise ValueError(f"flash_decode: {name} needs contiguous, 16-byte aligned positions")
    if B == 1:
        return t.shape[1]
    if t.stride(0) % row or t.stride(0) // row < t.shape[1]:
        raise ValueError(f"flash_decode: {name} batch stride is not a whole number of "
                         "positions")
    return t.stride(0) // row


def flash_decode_kernel(q, k, v, k_cur, v_cur, seq_len, scale, softcap=0.0, window=0):
    """Kernel K9 (CUDA tensors only): q [B, H, Dk], k/v [B, S, Hkv, D] (views
    as _positions_stride takes them), k/v_cur [B, Hkv, D], seq_len [B]
    int32 -> [B, H, Dv]."""
    what = "flash_decode"
    dt = check_dense_q(what, q)
    if k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{what}: k/v must be [B, S, Hkv, D]")
    B, Dk = q.shape[0], q.shape[2]
    Hkv = k.shape[2]
    s_k = _positions_stride("k", k, B, Hkv, Dk, dt, q.device)
    s_v = _positions_stride("v", v, B, Hkv, v.shape[-1], dt, q.device)
    if s_k != s_v or k.shape[1] != v.shape[1]:
        raise ValueError(f"{what}: k and v must have the same length and batch stride")
    return launch_dense_decode(what, q, k, v, 0, s_k, k.shape[1], k_cur, v_cur, seq_len, scale,
                               softcap, window)


def flash_decode_attention(q, k, v, k_cur, v_cur, seq_len, scale, softcap=0.0, window=0):
    """K9 with the JAX signature: the kernel on the card, the plain version
    on the CPU."""
    return build.on_device(q, flash_decode_kernel, flash_decode_attention_plain, k, v, k_cur,
                           v_cur, seq_len, scale, softcap=softcap, window=window)


def supported(cfg, cache, t: int) -> bool:
    """The JAX predicate (flash_decode.py:101-124): opted in with
    LLAMACOG_FLASH_DECODE=1, T = 1, the dense cache, head dims a multiple of
    8, whole GQA groups, no ALiBi or per-layer heads. (The port has no mesh.)"""
    if cfg.use_alibi or cfg.n_head_kv_arr:
        return False
    if os.environ.get("LLAMACOG_FLASH_DECODE", "0") != "1":
        return False
    return (t == 1 and isinstance(cache, KVCache) and cfg.head_dim_k % 8 == 0
            and cfg.head_dim_v % 8 == 0 and cfg.n_head % cfg.n_head_kv == 0)
