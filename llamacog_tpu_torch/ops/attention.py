"""Attention over a static KV cache plus the current block (plain PyTorch).

Counterpart of llamacog_tpu/ops/attention.py: masked attention that holds
per-row lengths and the sliding window in boolean masks, with the current
block's keys attended explicitly (the deferred KV write: the cache holds
only old tokens), and ALiBi's per-head distance bias (bloom, mpt, refact,
jais: alibi_slopes, alibi_distances). Softmax runs in f32. It is the plain
version the two attention kernels are held against (ops/cuda/flash_q8.py,
ops/cuda/flash_prefill.py).
"""

from __future__ import annotations

import math

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


def chunked_masks(seq_len: torch.Tensor, t: int, s: int, chunk: int):
    """Llama 4's chunked attention (the JAX _build_masks' chunked branch,
    llama.py:370-385): query i of a block written at offset seq_len
    (position p = seq_len + i) attends only within its chunk of `chunk`
    positions, to keys at positions >= (p // chunk) * chunk. Returns the
    old-cache mask [B, T, S] and the current block's mask, which depends on
    the absolute positions, [B, T, T]. Built on the device from seq_len
    alone, so a captured decode step rebuilds them at every replay."""
    dev = seq_len.device
    n = seq_len.long()[:, None, None]
    ti = torch.arange(t, device=dev)
    start = torch.div(n + ti[None, :, None], chunk, rounding_mode="floor") * chunk  # [B, T, 1]
    sj = torch.arange(s, device=dev)[None, None, :]
    old_ok = (sj < n) & (sj >= start)
    cur_ok = (ti[None, :] <= ti[:, None])[None] & (n + ti[None, None, :] >= start)
    return old_ok, cur_ok


def swa_ring_mask(write_pos: torch.Tensor, t: int, ring_w: int, window: int) -> torch.Tensor:
    """Boolean [B, T, W] over a sliding-window ring of W slots (the
    counterpart of kv_cache.py::build_swa_ring_mask): slot j of a row with
    write offset p holds absolute position a = p-1 - ((p-1-j) mod W), and
    query i (position p + i) may attend to it iff a >= 0 and a > p + i -
    window. Built on the device from write_pos alone, so a captured decode
    step rebuilds it at every replay."""
    dev = write_pos.device
    j = torch.arange(ring_w, device=dev)[None, None, :]
    p1 = write_pos.long()[:, None, None] - 1
    a = p1 - torch.remainder(p1 - j, ring_w)  # [B, 1, W]
    q = p1 + 1 + torch.arange(t, device=dev)[None, :, None]  # [B, T, 1]
    return (a >= 0) & (a > q - window)


# (n_head, max_bias, device) -> the slopes on the device: made once, so a
# step copies nothing from the host (a host copy cannot be captured in a
# CUDA graph)
_SLOPES: dict = {}


def alibi_slopes(n_head: int, max_bias: float, device=None) -> torch.Tensor:
    """ALiBi's per-head slopes [n_head] f32, ggml soft_max_ext's two branches
    (the JAX _alibi_slopes, llama.py:330-342): m0^(h + 1) for the first n2 =
    2^floor(log2 n_head) heads, m1^(2 (h - n2) + 1) for the rest (Jais-13B's
    heads 32-39), m0 = 2^(-max_bias / n2), m1 = 2^(-max_bias / (2 n2)); in
    f64 on the host, then f32."""
    key = (n_head, float(max_bias), str(device))
    if key not in _SLOPES:
        n2 = 2 ** math.floor(math.log2(n_head))
        m0, m1 = 2.0 ** (-max_bias / n2), 2.0 ** (-max_bias / (2 * n2))
        slopes = [m0 ** (h + 1) if h < n2 else m1 ** (2 * (h - n2) + 1) for h in range(n_head)]
        _SLOPES[key] = torch.tensor(slopes, dtype=torch.float32).to(device)
    return _SLOPES[key]


def alibi_distances(seq_len: torch.Tensor, t: int, s: int):
    """ALiBi's distances -(pos_q - pos_k) in f32 (the allowed cells of the
    JAX _build_masks' ALiBi masks, llama.py:357-368): over the old cache
    [B, T, S], query i of a block written at offset seq_len at position
    seq_len + i and slot j at position j; over the current block [T, T],
    -(i - j). Built on the device from seq_len alone, so a captured decode
    step rebuilds them at every replay. The masks say which cells count."""
    dev = seq_len.device
    ti = torch.arange(t, device=dev)
    pos_q = seq_len.long()[:, None, None] + ti[None, :, None]
    old = -(pos_q - torch.arange(s, device=dev)[None, None, :]).float()
    cur = -(ti[:, None] - ti[None, :]).float()
    return old, cur


def masked_attention(
    q: torch.Tensor,       # [B, T, H, Dk]
    k: torch.Tensor,       # [B, S, Hkv, Dk] old cache
    v: torch.Tensor,       # [B, S, Hkv, Dv]
    k_cur: torch.Tensor,   # [B, T, Hkv, Dk] this step's keys
    v_cur: torch.Tensor,   # [B, T, Hkv, Dv]
    old_ok: torch.Tensor,  # [B, T, S] bool
    cur_ok: torch.Tensor,  # [T, T] or [B, T, T] bool
    scale: float,
    logit_softcap: float = 0.0,
    alibi: tuple | None = None,  # (slopes [H], old distances [B, T, S], current [T, T])
) -> torch.Tensor:  # [B, T, H, Dv]
    """With `alibi`, each head's slope times the distance joins the scores
    in f32 after the scale and the softcap, before the mask selects the
    allowed cells: the JAX order (ops/attention.py:69-72). Query head h
    reads kv head h // rep, so h = kv_head * rep + r (multi-query models,
    Refact-1.6B's 32 over one, take the whole slope row)."""
    B, T, H, Dk = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    qf = q.float().reshape(B, T, Hkv, rep, Dk)
    scores = torch.cat([torch.einsum("bthrd,bshd->bhrts", qf, k.float()),
                        torch.einsum("bthrd,bshd->bhrts", qf, k_cur.float())], dim=-1) * scale
    if logit_softcap > 0.0:
        scores = logit_softcap * torch.tanh(scores / logit_softcap)
    if alibi is not None:
        slopes, d_old, d_cur = alibi
        dist = torch.cat([d_old, d_cur.expand(B, T, T)], dim=-1)[:, None, None]
        scores = scores + slopes.reshape(1, Hkv, rep, 1, 1) * dist
    allowed = torch.cat([old_ok, cur_ok.expand(B, T, T)], dim=-1)[:, None, None]
    # select (not add) the mask: masked slots may hold anything, and the
    # finite floor keeps fully-masked rows NaN-free
    scores = torch.where(allowed, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    out = (torch.einsum("bhrts,bshd->bthrd", probs[..., :S], v.float())
           + torch.einsum("bhrts,bshd->bthrd", probs[..., S:], v_cur.float()))
    return out.reshape(B, T, H, -1).to(q.dtype)
