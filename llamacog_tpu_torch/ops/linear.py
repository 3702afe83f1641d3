"""Quantized linear layers: the qmatmul / qmatmul_multi dispatch.

Counterpart of llamacog_tpu/ops/linear.py. A wire-format weight on a CUDA
tensor goes to the hand-written kernels (qmv at B <= 8, qgemm above — the
reference's mmvq/mmq split); a CPU tensor goes to the plain version. A
weight that carries int8 planes (quant/mmq.py, ``LLAMACOG_MMQ=1``) takes
the int8 GEMM (K13) from MMQ_MIN_B rows up, as the JAX qmm does
(ops/pallas/qmm.py:648-654); weights that share an input and all take it
share one quantization of that input. The kernels return f32 and the
result is cast back to the activation type, the cast points of the JAX
package (linear.py:82-84,128).
"""

from __future__ import annotations

import torch

from ..quant import mmq
from ..quant.wire import WireTensor
from .cuda.qmm import MAX_WEIGHTS, qmm_multi_cuda, qmm_plain, share_launch
from .cuda.qmm_i8 import qmm_i8, qmm_i8_quantized, quantize_i8


def _qmm_multi(x: torch.Tensor, ws) -> list[torch.Tensor]:
    if x.is_cuda:
        return qmm_multi_cuda(x, ws)
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return [qmm_plain(x, w) for w in ws]


def _uses_i8(x: torch.Tensor, w: WireTensor) -> bool:
    """The weight carries int8 planes and x has at least MMQ_MIN_B rows
    (read at call time, so a caller may lower it)."""
    return w.qi8 is not None and x.numel() // x.shape[-1] >= mmq.MMQ_MIN_B


def qmatmul(x: torch.Tensor, w) -> torch.Tensor:
    """x [..., K] @ W[N, K]^T -> [..., N] in x's dtype. W is a WireTensor
    or a dense tensor (dense weights go to torch.matmul in x's dtype with
    f32 accumulation, as the JAX package leaves them to XLA)."""
    if isinstance(w, WireTensor):
        if _uses_i8(x, w):
            return qmm_i8(x, w).to(x.dtype)
        return _qmm_multi(x, [w])[0].to(x.dtype)
    return torch.matmul(x.float(), w.to(x.dtype).float().T).to(x.dtype)


def qmatmul_multi(x: torch.Tensor, ws) -> list | None:
    """Several wire-format weights sharing x in ONE kernel launch (mixed
    kinds welcome: the Q4_K_M layer pairs Q4_K attn_qk with Q6_K attn_v).
    When every weight takes the int8 route (linear.py:109-113), x is
    quantized once and K13 runs per weight on the same (xq, xs): the
    results equal per-weight qmatmul bit for bit, where the JAX package
    leaves the repeated quantization to XLA to merge. Returns None when a
    weight cannot ride the fused launch (its kind not among those the
    kernels compile with the others': qmm.share_launch); the caller then
    runs per-weight qmatmul."""
    if not (1 <= len(ws) <= MAX_WEIGHTS and all(
            isinstance(w, WireTensor) and w.shape[1] == x.shape[-1] for w in ws)
            and share_launch(w.kind for w in ws)):
        return None
    if all(_uses_i8(x, w) for w in ws):
        lead = x.shape[:-1]
        xq, xs = quantize_i8(x.reshape(-1, x.shape[-1]))
        return [qmm_i8_quantized(xq, xs, w).reshape(*lead, w.shape[0]).to(x.dtype) for w in ws]
    return [o.to(x.dtype) for o in _qmm_multi(x, ws)]
