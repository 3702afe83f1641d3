"""int8 prefill planes (the mmq path, opt-in with ``LLAMACOG_MMQ=1``).

Counterpart of llamacog_tpu/quant/mmq.py. Each eligible weight is
re-expressed once, at engine start: the exact wire dequant (bit-exact
against the JAX package's planar decode), then symmetric int8 with one
scale per (row, MMQ_KB columns), as two planes carried on the WireTensor:
``qi8`` int8 [N, K] in natural column order and ``ws8T`` f32
[K / MMQ_KB, N]. Prefill chunks of at least MMQ_MIN_B rows then run the
int8 GEMM (ops/cuda/qmm_i8.py, kernel K13) over them; decode (B <= 8)
keeps the exact wire-format kernels.

Two deliberate differences from the JAX package (ROADMAP §3):

- :func:`attach_mmq_planes` returns a new params dict and leaves the
  caller's tree untouched (the JAX version attaches in place, so every
  other user of the tree takes the int8 route too);
- ``tok_embd`` and ``output`` get no planes: the embedding is a row gather
  and the LM head runs on the last position only (``logits_last``), so
  their planes would never be read (at a 32000-row vocab, which passes
  MMQ_MAX_N, they would cost ~131 MB).
"""

from __future__ import annotations

import dataclasses

import torch

from .wire import WireTensor, dequantize

MMQ_KB = 512       # columns per weight scale
MMQ_MIN_B = 256    # rows of a prefill chunk from which the int8 route runs
MMQ_MAX_N = 32768  # no planes for vocab-sized tensors
_NO_PLANES = ("tok_embd", "output")


def inv127() -> torch.Tensor:
    """f32(1 / 127). The JAX package writes `max|w| / 127.0`, which XLA
    compiles to a product with this constant: scales are formed so here."""
    return torch.tensor(1.0 / 127.0, dtype=torch.float32)


def eligible(w) -> bool:
    """The JAX filter (quant/mmq.py:72-76): a 2-D wire tensor with K a
    multiple of MMQ_KB and 256 <= N < MMQ_MAX_N, N a multiple of 256."""
    if not isinstance(w, WireTensor) or len(w.shape) != 2:
        return False
    n, k = w.shape
    return k % MMQ_KB == 0 and k >= MMQ_KB and 256 <= n < MMQ_MAX_N and n % 256 == 0


def build_mmq_planes(w: WireTensor) -> tuple[torch.Tensor, torch.Tensor] | None:
    """(qi8 int8 [N, K], ws8T f32 [K / MMQ_KB, N]) of an eligible weight, on
    its device, or None. The arithmetic of the jitted JAX `_build`,
    operation for operation in f32: s = max|w| * f32(1/127) per block (1
    where 0), q = clip(round_half_even(w / s), -127, 127)."""
    if not eligible(w):
        return None
    n, k = w.shape
    wb = dequantize(w, torch.float32).reshape(n, k // MMQ_KB, MMQ_KB)
    s = wb.abs().amax(dim=2) * inv127()
    s = torch.where(s == 0, torch.ones_like(s), s)
    q = wb.div_(s[:, :, None]).round_().clamp_(-127, 127)  # in place: one f32 copy
    return q.to(torch.int8).reshape(n, k), s.T.contiguous()


def attach_mmq_planes(params: dict) -> dict:
    """A new params dict whose eligible weights carry their int8 planes
    (built on their device, one tensor at a time). The caller's dict, its
    layer dicts and its WireTensors are left as they were; blocks and dense
    tensors are shared, not copied. A weight that already carries planes
    keeps them."""

    def attach(w):
        if not isinstance(w, WireTensor) or w.qi8 is not None:
            return w
        planes = build_mmq_planes(w)
        return w if planes is None else dataclasses.replace(w, qi8=planes[0], ws8T=planes[1])

    out = {k: (v if k in _NO_PLANES or k == "layers" else attach(v)) for k, v in params.items()}
    out["layers"] = [{k: attach(v) for k, v in layer.items()} for layer in params["layers"]]
    return out
