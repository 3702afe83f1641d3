"""int8 x int8 -> int32 prefill GEMM over the mmq planes: kernel K13, its
plain version, and the activation quantization around them.

Counterpart of llamacog_tpu/ops/pallas/qmm_i8.py, with its names:

- :func:`quantize_activations` is the JAX package's XLA glue (one max-abs
  scale per row, int8 payload) and stays plain torch, bit-exact with the
  jitted JAX expression;
- :func:`qmm_i8_kernel` (csrc/qmm_i8.cu, int8 tensor-core MMA) and
  :func:`qmm_i8_plain` compute ``out[B, N] f32 = xs * sum_g f32(xq[:, g] .
  qi8[:, g]^T) * ws8T[g]`` over the 512-column blocks g of K, in the same
  order with the same roundings, so the two agree bit for bit;
- :func:`qmm_i8` is the entry for ``x [..., K]`` and a WireTensor that
  carries planes (quant/mmq.py): the kernel for a CUDA tensor, the plain
  version for a CPU one.

The library yardstick ``torch._int_mm`` takes the int32 products only,
without the per-block scales, so it times less work than this function.
"""

from __future__ import annotations

import torch

from ...quant.mmq import MMQ_KB, inv127
from ...quant.wire import WireTensor
from . import build


def quantize_activations(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, K] -> (xq int8 [B, K], xs f32 [B, 1]): xs = max|x| * f32(1/127)
    per row (1 where 0), xq = clip(round_half_even(x / xs), -127, 127)."""
    xf = x.float()
    # a 0-dim CPU tensor rides a CUDA op as a scalar: no copy to the card,
    # which (from pageable memory) would make the host wait for the device
    xs = xf.abs().amax(dim=1, keepdim=True) * inv127()
    xs = torch.where(xs == 0, torch.ones_like(xs), xs)
    xq = (xf / xs).round_().clamp_(-127, 127).to(torch.int8)
    return xq, xs


def qmm_i8_plain(xq: torch.Tensor, xs: torch.Tensor, qi8: torch.Tensor,
                 ws8T: torch.Tensor) -> torch.Tensor:
    """The kernel's function in torch: xq int8 [B, K], xs f32 [B, 1], qi8
    int8 [N, K], ws8T f32 [K / 512, N] -> f32 [B, N]. Each block's
    product is taken in f32 on the int8 values: every partial sum is an
    integer below 127^2 * 512 < 2^24, so it is exact in any order (TF32
    must be off on the card). The blocks then combine as acc + p_g * ws8T[g]
    for g = 0, 1, ..., and the sum is scaled by xs."""
    acc = None
    for g in range(ws8T.shape[0]):
        cols = slice(g * MMQ_KB, (g + 1) * MMQ_KB)
        part = (xq[:, cols].float() @ qi8[:, cols].float().T) * ws8T[g]
        acc = part if acc is None else acc + part
    return acc * xs


def qmm_i8_kernel(xq: torch.Tensor, xs: torch.Tensor, qi8: torch.Tensor,
                  ws8T: torch.Tensor) -> torch.Tensor:
    """Kernel K13 (CUDA tensors only): shapes as :func:`qmm_i8_plain`, all
    contiguous, xq and qi8 16-byte aligned; any B (the ragged row edge is
    masked in the kernel), K a multiple of 512, N even."""
    what = "qmm_i8"
    if not xq.is_cuda:
        raise ValueError(f"{what}: xq must be a CUDA tensor, got {xq.device}")
    if xq.dim() != 2 or qi8.dim() != 2:
        raise ValueError(f"{what}: xq and qi8 must be 2-D")
    B, K = xq.shape
    N = qi8.shape[0]
    if K % MMQ_KB or K == 0 or N % 2 or N == 0 or B == 0:
        raise ValueError(f"{what}: unsupported shape B={B} N={N} K={K} (K a multiple of "
                         f"{MMQ_KB}, N even)")
    for name, t, dtype, shape in (("xq", xq, torch.int8, (B, K)),
                                  ("xs", xs, torch.float32, (B, 1)),
                                  ("qi8", qi8, torch.int8, (N, K)),
                                  ("ws8T", ws8T, torch.float32, (K // MMQ_KB, N))):
        if (t.dtype != dtype or tuple(t.shape) != shape or t.device != xq.device
                or not t.is_contiguous()):
            raise ValueError(f"{what}: {name} must be contiguous {dtype} {shape} on "
                             f"{xq.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if xq.data_ptr() % 16 or qi8.data_ptr() % 16:
        raise ValueError(f"{what}: xq and qi8 must be 16-byte aligned")
    out = torch.empty((B, N), dtype=torch.float32, device=xq.device)
    lib = build.load(what)
    rc = lib.lcg_qmm_i8(xq.data_ptr(), xs.data_ptr(), qi8.data_ptr(), ws8T.data_ptr(),
                        out.data_ptr(), B, N, K, torch.cuda.current_stream(xq.device).cuda_stream)
    build.check(lib, rc, what)
    build.LAUNCHES[what] += 1
    return out


def qmm_i8(x: torch.Tensor, w: WireTensor) -> torch.Tensor:
    """x [..., K] @ the int8 re-expression of w [N, K]^T -> [..., N] f32
    (JAX `qmm_i8`): the activations are quantized per row, then K13 runs
    (the plain version for a CPU tensor)."""
    if w.qi8 is None:
        raise ValueError("qmm_i8: the weight carries no int8 planes (quant/mmq.py)")
    lead, (N, K) = x.shape[:-1], w.shape
    xq, xs = quantize_activations(x.reshape(-1, K))
    out = build.on_device(xq, qmm_i8_kernel, qmm_i8_plain, xs, w.qi8, w.ws8T)
    return out.reshape(*lead, N)
