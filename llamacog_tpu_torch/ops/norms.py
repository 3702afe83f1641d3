"""Normalization layers (f32 compute, result in the input's dtype).

Counterpart of llamacog_tpu/ops/norms.py."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor | None, eps: float,
             bias: torch.Tensor | None = None) -> torch.Tensor:
    """RMS norm over the last axis; with no weight, the weightless norm
    (llama4's L2 q/k norm, ggml_rms_norm alone)."""
    xf = x.float()
    out = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    if weight is not None:
        out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor | None, bias: torch.Tensor | None,
               eps: float) -> torch.Tensor:
    """LayerNorm over the last axis (biased variance); the weight and the
    bias are each optional (command-r's norms carry no bias)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    if weight is not None:
        out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)
