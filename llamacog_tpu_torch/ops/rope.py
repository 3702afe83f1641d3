"""Rotary position embeddings with linear and YaRN scaling.

Counterpart of llamacog_tpu/ops/rope.py (ggml_rope_ext semantics). The
tables are computed once per step on the device from device positions, so
the decode loop needs no host round trip.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..models.config import RopeConfig


def _yarn_corr_dim(n_dims: int, n_ctx_orig: int, n_rot: float, base: float) -> float:
    return n_dims * math.log(n_ctx_orig / (n_rot * 2 * math.pi)) / (2 * math.log(base))


def rope_frequencies(cfg: RopeConfig, head_dim: int) -> tuple[np.ndarray, np.ndarray, float]:
    """Per-dim inverse frequencies and YaRN interpolation mix:
    (inv_freq [D/2], ramp_mix [D/2], mscale)."""
    dim = cfg.dim or head_dim
    exponents = np.arange(0, dim, 2, dtype=np.float64) / dim
    inv_freq = cfg.freq_base ** -exponents
    mscale = 1.0
    ramp = np.zeros_like(inv_freq)
    if cfg.scaling_type == "linear" and cfg.scaling_factor not in (0.0, 1.0):
        inv_freq = inv_freq / cfg.scaling_factor
    elif cfg.scaling_type == "yarn" and cfg.scaling_factor not in (0.0,):
        n_ctx_orig = cfg.orig_ctx_len or 2048
        lo = _yarn_corr_dim(dim, n_ctx_orig, cfg.beta_fast, cfg.freq_base)
        hi = _yarn_corr_dim(dim, n_ctx_orig, cfg.beta_slow, cfg.freq_base)
        lo, hi = max(0.0, math.floor(lo)), min(dim - 1.0, math.ceil(hi))
        dims = np.arange(0, dim, 2, dtype=np.float64)
        ramp = np.clip((dims / 2 - lo / 2) / max((hi - lo) / 2, 0.001), 0, 1)
        ramp = 1.0 - ramp  # 1 = interpolate (low freq), 0 = extrapolate
        mscale = float(
            cfg.attn_factor * (1.0 + 0.1 * math.log(cfg.scaling_factor))
            if cfg.scaling_factor > 1.0
            else cfg.attn_factor
        )
    return inv_freq.astype(np.float32), ramp.astype(np.float32), mscale


# (rope config, head dim, device) -> the step's inverse frequencies on the
# device: made once, so a step copies nothing from the host (a host copy
# cannot be captured in a CUDA graph)
_FREQS: dict = {}


def _step_frequencies(cfg: RopeConfig, head_dim: int, device) -> tuple[torch.Tensor, float]:
    key = (dataclasses.astuple(cfg), head_dim, str(device))
    if key not in _FREQS:
        inv_freq, ramp, mscale = rope_frequencies(cfg, head_dim)
        if cfg.scaling_type == "yarn" and cfg.scaling_factor not in (0.0, 1.0):
            inv_extrap = rope_frequencies(RopeConfig(dim=cfg.dim, freq_base=cfg.freq_base),
                                          head_dim)[0]
            inv_freq = (inv_extrap * (1 - ramp) + (inv_extrap / np.float32(cfg.scaling_factor))
                        * ramp).astype(np.float32)
        _FREQS[key] = (torch.from_numpy(inv_freq).to(device), mscale)
    return _FREQS[key]


def rope_tables(positions: torch.Tensor, cfg: RopeConfig, head_dim: int,
                freq_factors: torch.Tensor | None = None):
    """(cos, sin) [..., T, dim/2] f32, shared by all layers of a step."""
    inv, mscale = _step_frequencies(cfg, head_dim, positions.device)
    if freq_factors is not None:
        inv = inv / freq_factors.float()
    theta = positions[..., None].float() * inv
    return torch.cos(theta) * mscale, torch.sin(theta) * mscale


def apply_rope_tables(x: torch.Tensor, tables, dim: int | None = None,
                      interleaved: bool = False) -> torch.Tensor:
    """x [..., T, H, D]. Default NeoX pairing (i, i + dim/2); `interleaved`
    is ggml's mode-0 rope rotating pairs (2i, 2i+1) — the llama GGUF
    convention."""
    cos, sin = tables
    D = x.shape[-1]
    dim = dim or 2 * cos.shape[-1]
    cos = cos[..., None, :]  # broadcast over heads
    sin = sin[..., None, :]
    half = dim // 2
    x_rot = x[..., :dim].float()
    if interleaved:
        x1, x2 = x_rot[..., 0::2], x_rot[..., 1::2]
        out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
        out = out.reshape(*x_rot.shape[:-1], dim)
    else:
        x1, x2 = x_rot[..., :half], x_rot[..., half:]
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    if dim < D:
        out = torch.cat([out, x[..., dim:].float()], dim=-1)
    return out.to(x.dtype)


def rope_shift(x: torch.Tensor, delta: torch.Tensor, cfg: RopeConfig,
               freq_factors: torch.Tensor | None = None) -> torch.Tensor:
    """x [..., S, H, D] rotated by a per-position delta [S] (the re-rope of
    a context shift: rope is additive in the position, so rotating a key
    stored at p by d gives the key of p + d). The same tables as a step's
    (rope_tables, with the model's rope factors), so the JAX package's
    apply_rope(k, delta, ...) is matched operation for operation, and, as
    there, a model without rope (gpt2, starcoder) is moved unrotated."""
    if not cfg.enabled:
        return x
    D = x.shape[-1]
    return apply_rope_tables(x, rope_tables(delta, cfg, D, freq_factors), cfg.dim or D,
                             interleaved=cfg.interleaved)
