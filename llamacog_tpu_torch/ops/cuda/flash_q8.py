"""Attention read straight out of the stacked KV cache: kernels K4 (dense
decode), K6/K8 (quantized decode) and K7 (quantized prefill), each with its
plain version.

Counterpart of llamacog_tpu/ops/pallas/flash_q8.py, with its names and
signatures:

- flash_decode_stacked_dense (csrc/flash_decode_dense.cu) reads layer `il`
  of the dense [L, B, S, Hkv, D] cache in place, split over the cache
  positions: choose_splits picks the split count from s_eff on the host,
  the wrapper allocates the f32 workspace of the splits' partials, and one
  call launches the split kernel and the combine kernel
  (csrc/flash_split.cuh; the combine's plain version is
  combine_partials_plain);
- flash_decode_stacked (K6), flash_decode_q8 (K8a), flash_decode_q8_tiled
  (K8b) and flash_decode_q8_auto read the quantized planes
  (runtime/kv_cache.py) through one kernel, csrc/flash_decode_quant.cu,
  split over the cache positions as K4 is (choose_splits, a workspace, the
  combine of csrc/flash_split.cuh): the per-layer entries launch it as a
  one-layer stack, and the whole-S versus tiled choice of the TPU is the
  split rule's;
- flash_prefill_q8 (K7, csrc/flash_prefill_quant.cu) attends a prefill block
  over one layer's quantized planes plus the causal current block. In bf16
  the C entry runs K5's tensor-core tile loop with a loader that
  dequantizes the planes (head dims Dk == Dv, multiples of 32 up to 256,
  and 192/128, 16-byte aligned q and k_cur/v_cur); f32 and the other bf16
  calls run a SIMT body. The entry says which body it launched: they count
  as ``flash_prefill_quant`` (the tiles) and ``flash_prefill_quant_simt``.

Every kernel stops each row at its seq_len (and kv_cap) and folds the
current step's unquantized k_cur/v_cur in last (the deferred KV write).
q, k_cur, v_cur and the outputs are in natural head-dim order; the kernels
undo the planes' group-strided order by index. The plain versions
dequantize the planes to f32 (kv_dequant_planes), as the Pallas kernels do,
then run masked_attention. The `*_kernel` launchers take CUDA tensors only;
the entries with the JAX names run the plain version for CPU tensors and
the kernel otherwise.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from ...runtime.kv_cache import QuantKVCache, kv_dequant_planes, kv_plane_shapes
from ..attention import intra_block_mask, masked_attention, old_cache_mask
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
    what = "flash_decode_dense"
    dt = check_dense_q(what, q)
    L, B, S, Hkv, Dk = k_stack.shape
    for name, t, shape in (("k_stack", k_stack, (L, B, S, Hkv, Dk)),
                           ("v_stack", v_stack, (L, B, S, Hkv, v_stack.shape[-1]))):
        if tuple(t.shape) != shape or t.dtype != dt or t.device != q.device \
                or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous {dt} "
                             f"{shape} on {q.device}, got {t.dtype} {tuple(t.shape)}")
    if not 0 <= il < L:
        raise ValueError(f"{what}: layer {il} out of range")
    s_eff = S if kv_cap is None else min(int(kv_cap), S)
    return launch_dense_decode(what, q, k_stack, v_stack, il, S, s_eff, k_cur, v_cur, seq_len,
                               scale, softcap, window)


def check_dense_q(what, q) -> torch.dtype:
    """q's dtype, once q is a CUDA [B, H, Dk] tensor of a dtype the dense
    decode kernel takes."""
    if not q.is_cuda:
        raise ValueError(f"{what}: q must be a CUDA tensor, got {q.device}")
    if q.dtype not in build.DTYPE_ID:
        raise ValueError(f"{what}: dtype must be float32 or bfloat16, got {q.dtype}")
    if q.dim() != 3:
        raise ValueError(f"{what}: q must be [B, H, Dk], got {tuple(q.shape)}")
    return q.dtype


def launch_dense_decode(what, q, k, v, il, s_stride, s_eff, k_cur, v_cur, seq_len, scale,
                        softcap, window):
    """One launch of csrc/flash_decode_dense.cu, counted under `what`: layer
    `il` of k/v [.., B, S, Hkv, D], whose layers and batch rows lie
    s_stride positions apart (the caller has checked that layout), read to
    s_eff positions. Checks q, k/v_cur, seq_len and the head counts."""
    dt = q.dtype
    B, Hkv, Dk, Dv = k.shape[-4], k.shape[-2], k.shape[-1], v.shape[-1]
    H = q.shape[1]
    for name, t, shape in (("q", q, (B, H, Dk)), ("k_cur", k_cur, (B, Hkv, Dk)),
                           ("v_cur", v_cur, (B, Hkv, Dv))):
        if tuple(t.shape) != shape or t.dtype != dt or t.device != q.device \
                or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous {dt} {shape} on {q.device}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    _check_seq_len(what, seq_len, B, q.device)
    if H % Hkv or H // Hkv > MAX_REP or Dk > MAX_D or Dv > MAX_D or Dk % 8 or Dv % 8:
        raise ValueError(f"{what}: unsupported heads/dims H={H} Hkv={Hkv} Dk={Dk} Dv={Dv}")
    for name, t in (("q", q), ("k", k), ("v", v), ("k_cur", k_cur), ("v_cur", v_cur)):
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned")
    n_split, split_len = choose_splits(s_eff, B, Hkv)
    out = torch.empty((B, H, Dv), dtype=dt, device=q.device)
    ws = torch.empty((B, Hkv, n_split, H // Hkv, Dv + 2), dtype=torch.float32, device=q.device)
    lib = build.load("flash_decode_dense")
    rc = lib.lcg_flash_decode_dense(
        build.DTYPE_ID[dt], q.data_ptr(), k.data_ptr(), v.data_ptr(), il, B, s_stride, H, Hkv,
        Dk, Dv, k_cur.data_ptr(), v_cur.data_ptr(), seq_len.data_ptr(), out.data_ptr(), s_eff,
        float(scale), float(softcap), int(window), ws.data_ptr(), n_split, split_len,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, rc, what)
    build.LAUNCHES[what] += 1  # one count a call: the split and the combine launch
    return out


# Split-S decode (csrc/flash_split.cuh): about two waves of blocks on the
# H100's 132 SMs, each split at least SPLIT_MIN_LEN positions.
SPLIT_TARGET_BLOCKS = 2 * 132
SPLIT_MIN_LEN = 64
SPLIT_ALIGN = 16


@functools.lru_cache(maxsize=256)
def choose_splits(s_eff: int, B: int, Hkv: int) -> tuple[int, int]:
    """(n_split, split_len) of the split-S decode kernel, from host ints
    only: s_eff is the kv_cap bucket, constant over a decode loop, so the
    launch never reads the device seq_len. Splits of split_len positions (a
    multiple of SPLIT_ALIGN, at least SPLIT_MIN_LEN unless s_eff is
    shorter) cover s_eff, and none lies wholly past it."""
    s_eff = max(int(s_eff), 1)
    want = -(-SPLIT_TARGET_BLOCKS // (B * Hkv))
    n = max(1, min(want, s_eff // SPLIT_MIN_LEN))
    per = -(-s_eff // n)
    split_len = -(-per // SPLIT_ALIGN) * SPLIT_ALIGN
    return -(-s_eff // split_len), split_len


def combine_partials_plain(ws, live, q, k_cur, v_cur, scale, softcap=0.0):
    """The combine kernel in plain torch: merge the live splits' partials
    ws [B, Hkv, n_split, rep, Dv + 2] f32 (each split's unnormalised o[Dv],
    its maximum m and its sum l) with the current token k/v_cur
    [B, Hkv, D] -> [B, H, Dv] in q's dtype. live [B, n_split] bool: splits
    that are not live weigh nothing."""
    B, H, Dk = q.shape
    Hkv, Dv = k_cur.shape[1], v_cur.shape[-1]
    qf = q.float().reshape(B, Hkv, H // Hkv, Dk)
    s_cur = torch.einsum("bhrd,bhd->bhr", qf, k_cur.float()) * scale
    if softcap > 0.0:
        s_cur = softcap * torch.tanh(s_cur / softcap)
    on = live[:, None, :, None]  # [B, 1, n_split, 1]
    m_s = torch.where(on, ws[..., Dv], torch.full_like(ws[..., Dv], -1e30))
    mt = torch.maximum(m_s.amax(2), s_cur)  # [B, Hkv, rep]
    wgt = torch.where(on, torch.exp(m_s - mt[:, :, None]), torch.zeros_like(m_s))
    w_cur = torch.exp(s_cur - mt)
    den = (ws[..., Dv + 1] * wgt).sum(2) + w_cur
    o = (ws[..., :Dv] * wgt[..., None]).sum(2) + w_cur[..., None] * v_cur.float()[:, :, None]
    return (o / den[..., None]).reshape(B, H, Dv).to(q.dtype)


def _check_seq_len(what, seq_len, B, dev):
    if seq_len.dtype != torch.int32 or tuple(seq_len.shape) != (B,) or seq_len.device != dev:
        raise ValueError(f"{what}: seq_len must be int32 [B] on the same device")


# ---------------------------------------------------------------------------
# Quantized planes
# ---------------------------------------------------------------------------


def _flat_planes(planes, ndim):
    """Accept the cache's flat [.., S, Hkv*W] planes (ndim dims) or the
    unflattened [.., S, Hkv, W] form: merge the trailing two dims."""
    return tuple(p.reshape(*p.shape[:-2], p.shape[-2] * p.shape[-1])
                 if p.dim() == ndim + 1 else p for p in planes)


def _deq_layer(kind, planes, s, hkv):
    """One layer's flat planes [B, S, Hkv*W] -> f32 [B, s, Hkv, D]."""
    return kv_dequant_planes(
        kind, tuple(p[:, :s].reshape(p.shape[0], s, hkv, -1) for p in planes),
        torch.float32)


def flash_decode_stacked_plain(q, k_planes, v_planes, il, k_cur, v_cur, seq_len, scale,
                               softcap=0.0, window=0, kv_cap=None, kinds=("q8_0", "q8_0")):
    """Plain K6: q [B, H, Dk] over layer `il` of the stacked planes
    [L, B, S, Hkv*W] dequantized to f32 -> [B, H, Dv]."""
    k_planes, v_planes = _flat_planes(k_planes, 4), _flat_planes(v_planes, 4)
    Hkv = k_cur.shape[1]
    S = k_planes[0].shape[2] if kv_cap is None else min(kv_cap, k_planes[0].shape[2])
    k = _deq_layer(kinds[0], tuple(p[il] for p in k_planes), S, Hkv)
    v = _deq_layer(kinds[1], tuple(p[il] for p in v_planes), S, Hkv)
    return flash_decode_stacked_dense_plain(q, k[None], v[None], 0, k_cur, v_cur, seq_len,
                                            scale, softcap=softcap, window=window)


def flash_prefill_q8_plain(q, k_planes, v_planes, k_cur, v_cur, seq_len, scale, softcap=0.0,
                           window=0, kv_cap=None, kinds=("q8_0", "q8_0")):
    """Plain K7: q [B, T, H, Dk] over one layer's planes [B, S, Hkv*W]
    dequantized to f32, plus the causal current block -> [B, T, H, Dv]."""
    k_planes, v_planes = _flat_planes(k_planes, 3), _flat_planes(v_planes, 3)
    T, Hkv = q.shape[1], k_cur.shape[2]
    S = k_planes[0].shape[1] if kv_cap is None else min(kv_cap, k_planes[0].shape[1])
    k = _deq_layer(kinds[0], k_planes, S, Hkv)
    v = _deq_layer(kinds[1], v_planes, S, Hkv)
    return masked_attention(q, k, v, k_cur, v_cur, old_cache_mask(seq_len, T, S, window),
                            intra_block_mask(T, window, device=q.device), scale,
                            logit_softcap=softcap)


def _plane_ptrs(what, planes, kind, il, B, S, Hkv, D, dev):
    """Validate one tensor's stacked planes [L, B, S, Hkv*W] against its
    kind; the (q, s, m, h) pointers of layer `il`, None where the kind has
    no such plane."""
    shapes = kv_plane_shapes(kind, D)
    if len(planes) != len(shapes):
        raise ValueError(f"{what}: {kind} takes {len(shapes)} planes, got {len(planes)}")
    L = planes[0].shape[0]
    for p, (shp, dt) in zip(planes, shapes):
        want = (L, B, S, Hkv * shp[0])
        if tuple(p.shape) != want or p.dtype != dt or p.device != dev \
                or not p.is_contiguous() or p.data_ptr() % 16:
            raise ValueError(f"{what}: {kind} plane must be contiguous {dt} {want} on {dev}, "
                             f"got {p.dtype} {tuple(p.shape)} on {p.device}")
    if not 0 <= il < L:
        raise ValueError(f"{what}: layer {il} out of range")
    roles = (planes[0], planes[1] if len(planes) > 1 else None,
             planes[2] if kind in ("q4_1", "q5_1") else None,
             planes[-1] if kind in ("q5_0", "q5_1") else None)
    return [None if p is None else p[il].data_ptr() for p in roles]


def _check_attn_args(what, q, k_cur, v_cur, kinds, dims):
    if not q.is_cuda:
        raise ValueError(f"{what}: q must be a CUDA tensor, got {q.device}")
    dt = q.dtype
    if dt not in build.DTYPE_ID:
        raise ValueError(f"{what}: dtype must be float32 or bfloat16, got {dt}")
    for name, t in (("q", q), ("k_cur", k_cur), ("v_cur", v_cur)):
        if t.dtype != dt or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous {dt} on {q.device}")
    for kind in kinds:
        if kind not in build.KV_KIND_ID:
            raise ValueError(f"{what}: unknown kv kind {kind!r}")
    H, Hkv, Dk, Dv = dims
    if Hkv < 1 or H % Hkv or H // Hkv > MAX_REP or Dk > MAX_D or Dv > MAX_D \
            or Dk % 32 or Dv % 32:
        raise ValueError(f"{what}: unsupported heads/dims H={H} Hkv={Hkv} Dk={Dk} Dv={Dv}")


def flash_decode_quant_kernel(q, k_planes, v_planes, il, k_cur, v_cur, seq_len, scale,
                              softcap=0.0, window=0, kv_cap=None, kinds=("q8_0", "q8_0")):
    """The quantized decode kernel (CUDA tensors only): q [B, H, Dk] over
    layer `il` of the planes [L, B, S, Hkv*W] (or [L, B, S, Hkv, W]), k/v_cur
    [B, Hkv, D], seq_len [B] int32 -> [B, H, Dv]."""
    what = "flash_decode_quant"
    k_planes, v_planes = _flat_planes(k_planes, 4), _flat_planes(v_planes, 4)
    B, H, Dk = q.shape
    Hkv, Dv = k_cur.shape[1], v_cur.shape[-1]
    _check_attn_args(what, q, k_cur, v_cur, kinds, (H, Hkv, Dk, Dv))
    if tuple(k_cur.shape) != (B, Hkv, Dk) or tuple(v_cur.shape) != (B, Hkv, Dv):
        raise ValueError(f"{what}: k_cur/v_cur must be [B, Hkv, D]")
    _check_seq_len(what, seq_len, B, q.device)
    S = k_planes[0].shape[2]
    kptr = _plane_ptrs(what, k_planes, kinds[0], il, B, S, Hkv, Dk, q.device)
    vptr = _plane_ptrs(what, v_planes, kinds[1], il, B, S, Hkv, Dv, q.device)
    s_eff = S if kv_cap is None else min(int(kv_cap), S)
    n_split, split_len = choose_splits(s_eff, B, Hkv)
    out = torch.empty((B, H, Dv), dtype=q.dtype, device=q.device)
    ws = torch.empty((B, Hkv, n_split, H // Hkv, Dv + 2), dtype=torch.float32, device=q.device)
    lib = build.load("flash_decode_quant")
    rc = lib.lcg_flash_decode_quant(
        build.DTYPE_ID[q.dtype], build.KV_KIND_ID[kinds[0]], build.KV_KIND_ID[kinds[1]],
        q.data_ptr(), *kptr, *vptr, B, S, H, Hkv, Dk, Dv, k_cur.data_ptr(),
        v_cur.data_ptr(), seq_len.data_ptr(), out.data_ptr(), s_eff, float(scale),
        float(softcap), int(window), ws.data_ptr(), n_split, split_len,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, rc, what)
    build.LAUNCHES[what] += 1  # one count a call: the split and the combine launch
    return out


def flash_prefill_quant_kernel(q, k_planes, v_planes, k_cur, v_cur, seq_len, scale,
                               softcap=0.0, window=0, kv_cap=None, kinds=("q8_0", "q8_0")):
    """The quantized prefill kernel (CUDA tensors only): q [B, T, H, Dk]
    over one layer's planes [B, S, Hkv*W] (or [B, S, Hkv, W]) plus the
    causal current block k/v_cur [B, T, Hkv, D] -> [B, T, H, Dv]."""
    what = "flash_prefill_quant"
    k_planes, v_planes = _flat_planes(k_planes, 3), _flat_planes(v_planes, 3)
    B, T, H, Dk = q.shape
    Hkv, Dv = k_cur.shape[2], v_cur.shape[-1]
    _check_attn_args(what, q, k_cur, v_cur, kinds, (H, Hkv, Dk, Dv))
    if tuple(k_cur.shape) != (B, T, Hkv, Dk) or tuple(v_cur.shape) != (B, T, Hkv, Dv):
        raise ValueError(f"{what}: k_cur/v_cur must be [B, T, Hkv, D]")
    _check_seq_len(what, seq_len, B, q.device)
    S = k_planes[0].shape[1]
    kptr = _plane_ptrs(what, [p[None] for p in k_planes], kinds[0], 0, B, S, Hkv, Dk,
                       q.device)
    vptr = _plane_ptrs(what, [p[None] for p in v_planes], kinds[1], 0, B, S, Hkv, Dv,
                       q.device)
    s_eff = S if kv_cap is None else min(int(kv_cap), S)
    out = torch.empty((B, T, H, Dv), dtype=q.dtype, device=q.device)
    lib = build.load("flash_prefill_quant")
    simt = ctypes.c_int(0)
    rc = lib.lcg_flash_prefill_quant(
        build.DTYPE_ID[q.dtype], build.KV_KIND_ID[kinds[0]], build.KV_KIND_ID[kinds[1]],
        q.data_ptr(), *kptr, *vptr, B, S, T, H, Hkv, Dk, Dv, k_cur.data_ptr(),
        v_cur.data_ptr(), seq_len.data_ptr(), out.data_ptr(), s_eff, float(scale),
        float(softcap), int(window), ctypes.byref(simt),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, rc, what)
    build.LAUNCHES["flash_prefill_quant_simt" if simt.value else what] += 1
    return out


def flash_decode_stacked(q, k_planes, v_planes, il, k_cur, v_cur, seq_len, scale,
                         softcap=0.0, window=0, kv_cap=None, kinds=("q8_0", "q8_0")):
    """K6: decode attention over layer `il` of the stacked planes
    [L, B, S, Hkv*W]; q [B, H, Dk] -> [B, H, Dv], natural order."""
    return build.on_device(q, flash_decode_quant_kernel, flash_decode_stacked_plain, k_planes,
                           v_planes, il, k_cur, v_cur, seq_len, scale, softcap=softcap,
                           window=window, kv_cap=kv_cap, kinds=kinds)


def flash_decode_q8(q, k_planes, v_planes, k_cur, v_cur, seq_len, scale, softcap=0.0,
                    window=0, kv_cap=None, kinds=("q8_0", "q8_0")):
    """K8a: decode attention over one layer's planes [B, S, Hkv*W] (the
    same kernel as K6, as a one-layer stack)."""
    return flash_decode_stacked(q, [p[None] for p in k_planes], [p[None] for p in v_planes],
                                0, k_cur, v_cur, seq_len, scale, softcap=softcap,
                                window=window, kv_cap=kv_cap, kinds=kinds)


def flash_decode_q8_tiled(q, k_planes, v_planes, k_cur, v_cur, seq_len, scale, softcap=0.0,
                          window=0, kv_cap=None, kinds=("q8_0", "q8_0")):
    """K8b: the S-tiled per-layer entry. The kernel splits S over blocks at
    every depth, so this is flash_decode_q8 under the JAX name."""
    return flash_decode_q8(q, k_planes, v_planes, k_cur, v_cur, seq_len, scale,
                           softcap=softcap, window=window, kv_cap=kv_cap, kinds=kinds)


def flash_decode_q8_auto(q, k_planes, v_planes, k_cur, v_cur, seq_len, scale, softcap=0.0,
                         window=0, kv_cap=None, kinds=("q8_0", "q8_0")):
    """The JAX package picks the whole-S or the tiled kernel by a TPU VMEM
    rule; here both are the one kernel, so this is flash_decode_q8."""
    return flash_decode_q8(q, k_planes, v_planes, k_cur, v_cur, seq_len, scale,
                           softcap=softcap, window=window, kv_cap=kv_cap, kinds=kinds)


def flash_prefill_q8(q, k_planes, v_planes, k_cur, v_cur, seq_len, scale, softcap=0.0,
                     window=0, kv_cap=None, kinds=("q8_0", "q8_0")):
    """K7: prefill attention over one layer's planes [B, S, Hkv*W] plus the
    causal current block; q [B, T, H, Dk] -> [B, T, H, Dv]."""
    return build.on_device(q, flash_prefill_quant_kernel, flash_prefill_q8_plain, k_planes,
                           v_planes, k_cur, v_cur, seq_len, scale, softcap=softcap,
                           window=window, kv_cap=kv_cap, kinds=kinds)


def stacked_decode_supported(t: int) -> bool:
    """The stacked decode route (K4/K6, the default at T = 1), switched off
    by LLAMACOG_FLASH_STACKED=0 as in the JAX package (flash_q8.py:1034).
    The JAX predicate's other terms are TPU tiling rules or shapes the
    port's forward refuses; the kernels here take any S."""
    return t == 1 and os.environ.get("LLAMACOG_FLASH_STACKED", "1") == "1"


def decode_supported(cache, t: int) -> bool:
    """The per-layer quantized decode route (K8, flash_decode_q8_auto) when
    the stacked route is off: a quantized cache at T = 1, unless
    LLAMACOG_FLASH_Q8=0 (flash_q8.py:372), which leaves the masked path."""
    return (t == 1 and isinstance(cache, QuantKVCache)
            and os.environ.get("LLAMACOG_FLASH_Q8", "1") == "1")


def decode_from_cache(q, cache, il, k_cur, v_cur, seq_len, scale, softcap=0.0, window=0,
                      kv_cap=None):
    """Decode attention for layer `il` reading the stacked cache directly,
    dispatched on the cache type: the quantized planes go to K6, the dense
    store to K4 (kernels on the card, plain versions on the CPU). The
    kernels get layer il's [1, B, S, ...] slice, which is contiguous also
    where the cache is a one-row view of a larger one (KVCache.row)."""
    if isinstance(cache, QuantKVCache):
        return flash_decode_stacked(q, [p[il:il + 1] for p in cache.k_planes],
                                    [p[il:il + 1] for p in cache.v_planes], 0, k_cur, v_cur,
                                    seq_len, scale, softcap=softcap, window=window,
                                    kv_cap=kv_cap, kinds=cache.kinds)
    return build.on_device(q, flash_decode_stacked_dense, flash_decode_stacked_dense_plain,
                           cache.k[il:il + 1], cache.v[il:il + 1], 0, k_cur, v_cur, seq_len,
                           scale, softcap=softcap, window=window, kv_cap=kv_cap)
