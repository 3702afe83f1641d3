"""Decode attention out of the stacked dense cache: kernel K4 and its plain
version.

Counterpart of llamacog_tpu/ops/pallas/flash_q8.py's dense stacked path
(_flash_decode_stacked_dense / decode_from_cache). The kernel
(csrc/flash_decode_dense.cu) reads layer `il` of the [L, B, S, Hkv, D]
cache in place, stops each row at its seq_len, and folds the current
step's k_cur/v_cur in last.
"""

from __future__ import annotations

import torch

from ..attention import masked_attention, old_cache_mask
from . import build

MAX_REP = 16
MAX_D = 256


def flash_decode_stacked_dense_plain(q, k_stack, v_stack, il, k_cur, v_cur, seq_len,
                                     scale, softcap=0.0, window=0, kv_cap=None):
    """q [B, H, Dk] -> [B, H, Dv]: explicit softmax over the old tokens
    (positions < seq_len, within the window) plus the current token."""
    S = k_stack.shape[2] if kv_cap is None else min(kv_cap, k_stack.shape[2])
    k, v = k_stack[il, :, :S], v_stack[il, :, :S]
    cur_ok = torch.ones((1, 1), dtype=torch.bool, device=q.device)
    out = masked_attention(q[:, None], k, v, k_cur[:, None], v_cur[:, None],
                           old_cache_mask(seq_len, 1, S, window), cur_ok, scale,
                           logit_softcap=softcap)
    return out[:, 0]


def flash_decode_stacked_dense(q, k_stack, v_stack, il, k_cur, v_cur, seq_len, scale,
                               softcap=0.0, window=0, kv_cap=None):
    """Kernel K4 (CUDA tensors only): q [B, H, Dk], k/v_stack
    [L, B, S, Hkv, D], k/v_cur [B, Hkv, D], seq_len [B] int32 -> [B, H, Dv]."""
    if not q.is_cuda:
        raise ValueError(f"flash_decode_dense: q must be a CUDA tensor, got {q.device}")
    dt = q.dtype
    if dt not in build.DTYPE_ID:
        raise ValueError(f"flash_decode_dense: dtype must be float32 or bfloat16, got {dt}")
    L, B, S, Hkv, Dk = k_stack.shape
    H, Dv = q.shape[1], v_stack.shape[-1]
    for name, t, shape in (("q", q, (B, H, Dk)), ("k_stack", k_stack, (L, B, S, Hkv, Dk)),
                           ("v_stack", v_stack, (L, B, S, Hkv, Dv)),
                           ("k_cur", k_cur, (B, Hkv, Dk)), ("v_cur", v_cur, (B, Hkv, Dv))):
        if tuple(t.shape) != shape or t.dtype != dt or t.device != q.device \
                or not t.is_contiguous():
            raise ValueError(f"flash_decode_dense: {name} must be contiguous {dt} "
                             f"{shape} on {q.device}, got {t.dtype} {tuple(t.shape)}")
    if seq_len.dtype != torch.int32 or tuple(seq_len.shape) != (B,) \
            or seq_len.device != q.device:
        raise ValueError("flash_decode_dense: seq_len must be int32 [B] on the same device")
    if H % Hkv or H // Hkv > MAX_REP or Dk > MAX_D or Dv > MAX_D or Dk % 8:
        raise ValueError(f"flash_decode_dense: unsupported heads/dims H={H} Hkv={Hkv} "
                         f"Dk={Dk} Dv={Dv}")
    if not 0 <= il < L:
        raise ValueError(f"flash_decode_dense: layer {il} out of range")
    s_eff = S if kv_cap is None else min(int(kv_cap), S)
    out = torch.empty((B, H, Dv), dtype=dt, device=q.device)
    lib = build.load("flash_decode_dense")
    rc = lib.lcg_flash_decode_dense(
        build.DTYPE_ID[dt], q.data_ptr(), k_stack.data_ptr(), v_stack.data_ptr(), il, B, S, H,
        Hkv, Dk, Dv, k_cur.data_ptr(), v_cur.data_ptr(), seq_len.data_ptr(),
        out.data_ptr(), s_eff, float(scale), float(softcap), int(window),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, rc, "flash_decode_dense")
    build.LAUNCHES["flash_decode_dense"] += 1
    return out


def decode_from_cache(q, cache, il, k_cur, v_cur, seq_len, scale, softcap=0.0, window=0,
                      kv_cap=None):
    """Decode attention for layer `il` reading the stacked cache directly:
    the kernel on the card, the plain version on the CPU."""
    if q.is_cuda:
        return flash_decode_stacked_dense(q, cache.k, cache.v, il, k_cur, v_cur, seq_len,
                                          scale, softcap=softcap, window=window,
                                          kv_cap=kv_cap)
    if q.device.type != "cpu":
        raise ValueError(f"unsupported device {q.device}")
    return flash_decode_stacked_dense_plain(q, cache.k, cache.v, il, k_cur, v_cur, seq_len,
                                            scale, softcap=softcap, window=window,
                                            kv_cap=kv_cap)
