"""Fused dequant x matmul: the qmv and qgemm kernels and their plain version.

Counterpart of llamacog_tpu/ops/pallas/qmm.py. ``out[B, N] f32 =
x[B, K] @ dequant(W)[N, K]^T`` for one or several wire-format weights
sharing x:

* B <= 8, or f32 activations: ``qmv`` (csrc/qmv.cu), f32 operands — K1,
  and K3 at decode;
* bf16 activations at B > 8: ``qgemm`` (csrc/qgemm.cu), bf16 operands with
  f32 accumulation — K2, and K3 at prefill.

Operands are thus rounded to bf16 only where the activations are bf16 and
the batch is a GEMM batch, as the Pallas kernels round at B > 8 on a bf16
model; an f32 model keeps f32 operands, as the JAX package's f32 path does.

The launchers take CUDA tensors only and raise otherwise; ``ops/linear.py``
sends CPU tensors to :func:`qmm_plain`. No single PyTorch call computes a
product against GGUF blocks, so qmm has no library yardstick.
"""

from __future__ import annotations

import ctypes

import torch

from ...quant.wire import WireTensor, dequantize
from . import build

QMV_MAX_B = 8
MAX_WEIGHTS = 4
_KIND_ID = {"Q4_K": 0, "Q6_K": 1}


def uses_qgemm(x: torch.Tensor) -> bool:
    """bf16 activations at a GEMM batch take qgemm; all else takes qmv."""
    b = x.numel() // x.shape[-1]
    return x.dtype == torch.bfloat16 and b > QMV_MAX_B


def qmm_plain(x: torch.Tensor, w: WireTensor) -> torch.Tensor:
    """x [..., K] @ dequant(w)^T -> [..., N] f32, cast as the kernels cast:
    bf16-rounded operands with f32 accumulation where qgemm runs (bf16
    values are exact in f32, so the f32 product of the rounded operands is
    that of a bf16 x bf16 -> f32 kernel), f32 operands elsewhere."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    wd = dequantize(w, torch.float32)
    if uses_qgemm(x2):
        out = x2.float() @ wd.to(torch.bfloat16).float().T
    else:
        out = x2.float() @ wd.T
    return out.reshape(*lead, w.shape[0])


def _launch(fn_name: str, counter: str, x: torch.Tensor, ws) -> list[torch.Tensor]:
    if not x.is_cuda:
        raise ValueError(f"{counter}: x must be a CUDA tensor, got {x.device}")
    if x.dtype not in build.DTYPE_ID:
        raise ValueError(f"{counter}: x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{counter}: x must be a contiguous [B, K] tensor")
    B, K = x.shape
    if not 1 <= len(ws) <= MAX_WEIGHTS:
        raise ValueError(f"{counter}: takes 1 to {MAX_WEIGHTS} weights, got {len(ws)}")
    for w in ws:
        if not isinstance(w, WireTensor) or w.kind not in _KIND_ID or len(w.shape) != 2:
            raise ValueError(f"{counter}: weights must be 2-D Q4_K/Q6_K WireTensors")
        if w.device != x.device or not w.blocks.is_contiguous():
            raise ValueError(f"{counter}: weight blocks must be contiguous on {x.device}")
        if w.shape[1] != K:
            raise ValueError(f"{counter}: weight K={w.shape[1]} != x K={K}")
        if w.blocks.data_ptr() % 16:
            raise ValueError(f"{counter}: weight blocks must be 16-byte aligned")
    if x.data_ptr() % 16:
        raise ValueError(f"{counter}: x must be 16-byte aligned")
    outs = [torch.empty((B, w.shape[0]), dtype=torch.float32, device=x.device) for w in ws]
    n = len(ws)
    lib = build.load(counter)
    rc = getattr(lib, fn_name)(
        x.data_ptr(), build.DTYPE_ID[x.dtype], B, K, n,
        (ctypes.c_void_p * n)(*[w.blocks.data_ptr() for w in ws]),
        (ctypes.c_void_p * n)(*[o.data_ptr() for o in outs]),
        (ctypes.c_int * n)(*[_KIND_ID[w.kind] for w in ws]),
        (ctypes.c_int * n)(*[w.shape[0] for w in ws]),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, rc, counter)
    build.LAUNCHES[counter] += 1
    return outs


def qmv(x: torch.Tensor, ws) -> list[torch.Tensor]:
    """Kernel K1/K3, f32 operands: one launch for all `ws` (CUDA tensors).
    Any B; the weights stream once per QMV_MAX_B rows of x."""
    return _launch("lcg_qmv", "qmv", x, ws)


def qgemm(x: torch.Tensor, ws) -> list[torch.Tensor]:
    """Kernel K2/K3, bf16 x at any B: one launch for all `ws` (CUDA tensors)."""
    if x.dtype != torch.bfloat16:
        raise ValueError(f"qgemm: x must be bfloat16, got {x.dtype}")
    return _launch("lcg_qgemm", "qgemm", x, ws)


def qmm_multi_cuda(x: torch.Tensor, ws) -> list[torch.Tensor]:
    """x [..., K] on the card -> [..., N_t] f32 per weight, in ONE launch
    of qgemm or qmv (uses_qgemm)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    outs = (qgemm if uses_qgemm(x2) else qmv)(x2, ws)
    return [o.reshape(*lead, w.shape[0]) for o, w in zip(outs, ws)]
