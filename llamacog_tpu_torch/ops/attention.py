"""Attention over a static KV cache plus the current block (plain PyTorch).

Counterpart of llamacog_tpu/ops/attention.py: masked attention that holds
per-row lengths and the sliding window in boolean masks, with the current
block's keys attended explicitly (the deferred KV write: the cache holds
only old tokens). Softmax runs in f32. It is the plain version the two
attention kernels are held against (ops/cuda/flash_q8.py,
ops/cuda/flash_prefill.py).
"""

from __future__ import annotations

import torch


def old_cache_mask(seq_len: torch.Tensor, t: int, s: int, window: int = 0) -> torch.Tensor:
    """Boolean [B, T, S]: query i of a block written at offset seq_len
    (absolute position seq_len + i) may attend to old cache slot j iff
    j < seq_len and, with a sliding window, j > seq_len + i - window."""
    dev = seq_len.device
    ti = torch.arange(t, device=dev)[None, :, None]
    sj = torch.arange(s, device=dev)[None, None, :]
    n = seq_len.long()[:, None, None]
    ok = sj < n
    if window > 0:
        ok = ok & (sj > n + ti - window)
    return ok.expand(-1, t, -1)


def intra_block_mask(t: int, window: int = 0, device=None) -> torch.Tensor:
    """Boolean [T, T] of the current block: keys j <= queries i, within the
    window."""
    ti = torch.arange(t, device=device)
    ok = ti[None, :] <= ti[:, None]
    if window > 0:
        ok = ok & (ti[None, :] > ti[:, None] - window)
    return ok


def masked_attention(
    q: torch.Tensor,       # [B, T, H, Dk]
    k: torch.Tensor,       # [B, S, Hkv, Dk] old cache
    v: torch.Tensor,       # [B, S, Hkv, Dv]
    k_cur: torch.Tensor,   # [B, T, Hkv, Dk] this step's keys
    v_cur: torch.Tensor,   # [B, T, Hkv, Dv]
    old_ok: torch.Tensor,  # [B, T, S] bool
    cur_ok: torch.Tensor,  # [T, T] bool
    scale: float,
    logit_softcap: float = 0.0,
) -> torch.Tensor:  # [B, T, H, Dv]
    B, T, H, Dk = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, T, Hkv, H // Hkv, Dk)
    scores = torch.cat([torch.einsum("bthrd,bshd->bhrts", qf, k.float()),
                        torch.einsum("bthrd,bshd->bhrts", qf, k_cur.float())], dim=-1) * scale
    if logit_softcap > 0.0:
        scores = logit_softcap * torch.tanh(scores / logit_softcap)
    allowed = torch.cat([old_ok, cur_ok.expand(B, T, T)], dim=-1)[:, None, None]
    # select (not add) the mask: masked slots may hold anything, and the
    # finite floor keeps fully-masked rows NaN-free
    scores = torch.where(allowed, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    out = (torch.einsum("bhrts,bshd->bthrd", probs[..., :S], v.float())
           + torch.einsum("bhrts,bshd->bthrd", probs[..., S:], v_cur.float()))
    return out.reshape(B, T, H, -1).to(q.dtype)
