"""Prefill attention over the old cache plus the causal current block:
kernel K5 and its plain version.

Counterpart of llamacog_tpu/ops/pallas/flash_prefill.py. The kernel
(csrc/flash_prefill.cu) reads the old cache [B, S, Hkv, D] by stride —
a layer of the stacked cache, sliced to kv_cap, needs no copy — and takes
any S and any T, and any head dims up to MAX_D in both types. In bf16 the
C entry runs the tensor-core tiles at the head dims they take (Dk == Dv a
multiple of 16, or 192/128) when every row is 16-byte aligned, and a bf16
instantiation of the SIMT body otherwise; f32 always runs the SIMT body.
The C entry says which body it launched: they count as ``flash_prefill``
(the tiles) and ``flash_prefill_simt``.
"""

from __future__ import annotations

import ctypes

import torch

from ..attention import intra_block_mask, masked_attention, old_cache_mask
from . import build

MAX_D = 256


def flash_prefill_attention_plain(q, k, v, k_cur, v_cur, seq_len, scale, softcap=0.0,
                                  window=0):
    """q [B, T, H, Dk] -> [B, T, H, Dv]: explicit softmax over the old slots
    below seq_len and the causal current block, within the window."""
    T, S = q.shape[1], k.shape[1]
    return masked_attention(q, k, v, k_cur, v_cur, old_cache_mask(seq_len, T, S, window),
                            intra_block_mask(T, window, device=q.device), scale,
                            logit_softcap=softcap)


def _check_cache_view(name, t, B, Hkv, D, dt, dev):
    if t.dim() != 4 or t.shape[0] != B or tuple(t.shape[2:]) != (Hkv, D) \
            or t.dtype != dt or t.device != dev:
        raise ValueError(f"flash_prefill: {name} must be {dt} [B, S, {Hkv}, {D}] on {dev}, "
                         f"got {t.dtype} {tuple(t.shape)}")
    if t.stride(3) != 1 or t.stride(2) != D:
        raise ValueError(f"flash_prefill: {name} needs contiguous head and dim axes")


def flash_prefill_kernel(q, k, v, k_cur, v_cur, seq_len, scale, softcap=0.0, window=0):
    """Kernel K5 (CUDA tensors only): q [B, T, H, Dk], k/v [B, S, Hkv, D]
    (any batch and position strides), k/v_cur [B, T, Hkv, D], seq_len [B]
    int32 -> [B, T, H, Dv]."""
    if not q.is_cuda:
        raise ValueError(f"flash_prefill: q must be a CUDA tensor, got {q.device}")
    dt = q.dtype
    if dt not in build.DTYPE_ID:
        raise ValueError(f"flash_prefill: dtype must be float32 or bfloat16, got {dt}")
    B, T, H, Dk = q.shape
    Hkv, Dv = k.shape[2], v.shape[-1]
    if not q.is_contiguous():
        raise ValueError("flash_prefill: q must be contiguous")
    _check_cache_view("k", k, B, Hkv, Dk, dt, q.device)
    _check_cache_view("v", v, B, Hkv, Dv, dt, q.device)
    if k.shape[1] != v.shape[1]:
        raise ValueError("flash_prefill: k and v lengths differ")
    for name, t, shape in (("k_cur", k_cur, (B, T, Hkv, Dk)), ("v_cur", v_cur, (B, T, Hkv, Dv))):
        if tuple(t.shape) != shape or t.dtype != dt or t.device != q.device \
                or not t.is_contiguous():
            raise ValueError(f"flash_prefill: {name} must be contiguous {dt} {shape}")
    if seq_len.dtype != torch.int32 or tuple(seq_len.shape) != (B,) \
            or seq_len.device != q.device:
        raise ValueError("flash_prefill: seq_len must be int32 [B] on the same device")
    if H % Hkv or Dk > MAX_D or Dv > MAX_D:
        raise ValueError(f"flash_prefill: unsupported heads/dims H={H} Hkv={Hkv} "
                         f"Dk={Dk} Dv={Dv}")
    out = torch.empty((B, T, H, Dv), dtype=dt, device=q.device)
    lib = build.load("flash_prefill")
    simt = ctypes.c_int(0)
    rc = lib.lcg_flash_prefill(
        build.DTYPE_ID[dt], q.data_ptr(), k.data_ptr(), v.data_ptr(), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), k_cur.data_ptr(), v_cur.data_ptr(), seq_len.data_ptr(),
        out.data_ptr(), B, T, H, Hkv, Dk, Dv, k.shape[1], float(scale), float(softcap),
        int(window), ctypes.byref(simt), torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, rc, "flash_prefill")
    build.LAUNCHES["flash_prefill_simt" if simt.value else "flash_prefill"] += 1
    return out


def flash_prefill_attention(q, k, v, k_cur, v_cur, seq_len, scale, softcap=0.0, window=0):
    """The kernel on the card, the plain version on the CPU."""
    if q.is_cuda:
        return flash_prefill_kernel(q, k, v, k_cur, v_cur, seq_len, scale, softcap, window)
    if q.device.type != "cpu":
        raise ValueError(f"unsupported device {q.device}")
    return flash_prefill_attention_plain(q, k, v, k_cur, v_cur, seq_len, scale, softcap,
                                         window)
