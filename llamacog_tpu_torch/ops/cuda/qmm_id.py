"""Sparse MoE expert products over stacked wire-format experts (mul_mat_id):
kernels K10, K11 and K12, each with its plain version.

Counterpart of llamacog_tpu/ops/pallas/qmm_id.py, with its names and
contracts. The experts stay one stacked WireTensor [n_exp, N, K] (blocks
[n_exp * N, row_bytes]) of any kind the dense kernels take; only the
selected experts' bytes are read:

- qmm_gather (K10, csrc/qmv_id.cu): x [S, K] rows, ids [S] expert per row
  -> [S, N] f32 with out[s] = x[s] @ dequant(W[ids[s]])^T; f32 operands.
- qmm_gather_offset (K12): the same contract. The TPU ran it as one launch
  per row; here it is one launch of the K10 kernel over all rows, so the
  model never chooses it over qmm_gather (no GATHER_OFFSET_MAX setting).
- qmm_ragged (K11, csrc/qgemm_id.cu): xs [S_pad, K] sorted by expert and
  padded so token tile i (tt rows) belongs to expert tile_expert[i] ->
  [S_pad, N] f32. bf16 activations take the grouped GEMM (bf16 operands,
  f32 accumulation; tt a multiple of 16: a block gathers the tiles of its
  expert, dequantizes its weight strip once per pass of up to 64 of those
  rows and multiplies all of them against it); f32 activations take the
  K10 kernel over ids_rows = repeat(tile_expert, tt), the JAX package's
  own non-TPU route (models/llama.py:168-169).

A row (or tile) whose expert lies outside [0, n_exp) gives zeros and reads
no weights: the MoE sort (models/llama.py::moe_sort) marks the padding
tiles past the last used expert so. The kernels read ids and tile_expert
from device memory, so no routing result goes to the host. The ``*_kernel``
launchers take CUDA tensors only; the entries with the JAX names run the
plain version for CPU tensors and the kernel otherwise. No single PyTorch
call multiplies by GGUF blocks, so these kernels have no library yardstick.
"""

from __future__ import annotations

import torch

from ...quant.wire import WireTensor, dequantize_experts
from . import build
from .qmm import _KIND_ID

RAGGED_TILE = 16  # the model's token tile (models/llama.py::moe_sort's padding)
RAGGED_TILE_STEP = 16  # qgemm_id takes any multiple of this
RAGGED_MAX_TILES = 1024  # token tiles a qgemm_id launch
RAGGED_MAX_EXPERTS = 256  # experts of a stack qgemm_id takes


def _plain(x: torch.Tensor, ids: torch.Tensor, w: WireTensor, bf16_weights: bool):
    """Expert by expert: decode one used expert, multiply its rows, drop it
    (one expert of a Mixtral stack is 0.47 GB in f32; the stack never is
    decoded whole). Rows whose id is outside [0, n_exp) stay zero."""
    n_exp, n, _ = w.shape
    out = torch.zeros((x.shape[0], n), dtype=torch.float32, device=x.device)
    xf = x.float()
    for e in range(n_exp):
        sel = ids == e
        if not bool(sel.any()):
            continue
        wd = dequantize_experts(w, torch.tensor([e]))[0]
        if bf16_weights:
            wd = wd.to(torch.bfloat16).float()
        out[sel] = xf[sel] @ wd.T
    return out


def qmm_gather_plain(x: torch.Tensor, ids: torch.Tensor, w: WireTensor) -> torch.Tensor:
    """Plain K10/K12: f32 operands, as the kernel."""
    return _plain(x, ids, w, False)


def qmm_ragged_plain(xs: torch.Tensor, tile_expert: torch.Tensor, w: WireTensor,
                     tt: int) -> torch.Tensor:
    """Plain K11, any tt: bf16-rounded weights against bf16 activations
    (the grouped GEMM's operands; bf16 values are exact in f32, so the f32
    product of the rounded operands is that of a bf16 x bf16 -> f32 GEMM),
    f32 operands for f32 activations (the K10 route)."""
    ids_rows = tile_expert.repeat_interleave(tt)
    return _plain(xs, ids_rows, w, xs.dtype == torch.bfloat16)


def _check(what: str, x: torch.Tensor, ids: torch.Tensor, w: WireTensor, dtypes) -> None:
    if not x.is_cuda:
        raise ValueError(f"{what}: x must be a CUDA tensor, got {x.device}")
    if x.dtype not in dtypes:
        raise ValueError(f"{what}: x must be one of {dtypes}, got {x.dtype}")
    if not isinstance(w, WireTensor) or len(w.shape) != 3 or w.kind not in _KIND_ID:
        raise ValueError(f"{what}: w must be a stacked {'/'.join(_KIND_ID)} WireTensor "
                         f"[n_exp, N, K], got {getattr(w, 'kind', type(w))} "
                         f"{getattr(w, 'shape', '')}")
    if x.dim() != 2 or not x.is_contiguous() or x.shape[1] != w.shape[2]:
        raise ValueError(f"{what}: x must be a contiguous [rows, {w.shape[2]}] tensor, "
                         f"got {tuple(x.shape)}")
    if w.device != x.device or not w.blocks.is_contiguous() or w.blocks.data_ptr() % 16 \
            or x.data_ptr() % 16:
        raise ValueError(f"{what}: x and the expert blocks must be 16-byte aligned on "
                         f"{x.device}")
    if ids.dtype != torch.int32 or ids.device != x.device or ids.dim() != 1 \
            or not ids.is_contiguous():
        raise ValueError(f"{what}: expert ids must be a contiguous int32 vector on {x.device}")


def qmv_id_kernel(x: torch.Tensor, ids: torch.Tensor, w: WireTensor) -> torch.Tensor:
    """Kernel K10/K12 (CUDA tensors only): x [S, K] f32 or bf16, ids [S]
    int32 -> [S, N] f32."""
    _check("qmv_id", x, ids, w, (torch.float32, torch.bfloat16))
    if ids.shape[0] != x.shape[0]:
        raise ValueError(f"qmv_id: {ids.shape[0]} ids for {x.shape[0]} rows")
    n_exp, n, k = w.shape
    out = torch.empty((x.shape[0], n), dtype=torch.float32, device=x.device)
    lib = build.load("qmv_id")
    rc = lib.lcg_qmv_id(x.data_ptr(), build.DTYPE_ID[x.dtype], x.shape[0], k,
                        w.blocks.data_ptr(), _KIND_ID[w.kind], n_exp, n, ids.data_ptr(),
                        out.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, rc, "qmv_id")
    build.LAUNCHES["qmv_id"] += 1
    return out


def qgemm_id_kernel(xs: torch.Tensor, tile_expert: torch.Tensor, w: WireTensor,
                    tt: int) -> torch.Tensor:
    """Kernel K11 (CUDA tensors only): xs [S_pad, K] bf16, tile_expert
    [S_pad / tt] int32 (at most RAGGED_MAX_TILES), tt a multiple of 16, at
    most RAGGED_MAX_EXPERTS experts -> [S_pad, N] f32."""
    if tt <= 0 or tt % RAGGED_TILE_STEP:
        raise ValueError(f"qgemm_id: the token tile must be a multiple of "
                         f"{RAGGED_TILE_STEP}, got {tt}")
    _check("qgemm_id", xs, tile_expert, w, (torch.bfloat16,))
    if w.shape[0] > RAGGED_MAX_EXPERTS:
        raise ValueError(f"qgemm_id: at most {RAGGED_MAX_EXPERTS} experts, got {w.shape[0]}")
    if xs.shape[0] != tile_expert.shape[0] * tt or not 0 < tile_expert.shape[0] <= \
            RAGGED_MAX_TILES:
        raise ValueError(f"qgemm_id: {tile_expert.shape[0]} tiles of {tt} for "
                         f"{xs.shape[0]} rows (1 to {RAGGED_MAX_TILES} tiles)")
    n_exp, n, k = w.shape
    out = torch.empty((xs.shape[0], n), dtype=torch.float32, device=xs.device)
    lib = build.load("qgemm_id")
    rc = lib.lcg_qgemm_id(xs.data_ptr(), build.DTYPE_ID[xs.dtype], xs.shape[0], k,
                          w.blocks.data_ptr(), _KIND_ID[w.kind], n_exp, n,
                          tile_expert.data_ptr(), tt, out.data_ptr(),
                          torch.cuda.current_stream(xs.device).cuda_stream)
    build.check(lib, rc, "qgemm_id")
    build.LAUNCHES["qgemm_id"] += 1
    return out


def qmm_gather(x: torch.Tensor, ids: torch.Tensor, w: WireTensor) -> torch.Tensor:
    """K10: x [S, K] rows, ids [S] expert per row, w stacked [n_exp, N, K]
    -> [S, N] f32 where out[s] = x[s] @ dequant(w[ids[s]])^T."""
    return build.on_device(x, qmv_id_kernel, qmm_gather_plain, ids, w)


def qmm_gather_offset(x: torch.Tensor, ids: torch.Tensor, w: WireTensor) -> torch.Tensor:
    """K12: qmm_gather's contract, through the same kernel."""
    return qmm_gather(x, ids, w)


def _ragged_cuda(xs, tile_expert, w, tt):
    if xs.dtype == torch.bfloat16:
        return qgemm_id_kernel(xs, tile_expert, w, tt)
    return qmv_id_kernel(xs, tile_expert.repeat_interleave(tt), w)


def qmm_ragged(xs: torch.Tensor, tile_expert: torch.Tensor, w: WireTensor,
               tt: int) -> torch.Tensor:
    """K11: grouped GEMM over expert-sorted rows. xs [S_pad, K]: token tile
    i (rows [i*tt, (i+1)*tt)) belongs entirely to expert tile_expert[i].
    Returns [S_pad, N] f32."""
    return build.on_device(xs, _ragged_cuda, qmm_ragged_plain, tile_expert, w, tt)
