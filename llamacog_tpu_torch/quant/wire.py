"""Quantized weights in GGUF wire format on the device.

Counterpart of llamacog_tpu/quant/planar.py and the K-quant decoders of
quant/decode_np.py. The planar layout exists for the TPU (lane-aligned
unpack, group-strided columns, f32 scale planes, transposed superblock
planes); none of its reasons hold on a GPU, so a weight stays here exactly
as the file stores it: a ``uint8 [N, row_bytes]`` tensor of ggml blocks
(block_q4_K: 144 bytes per 256 weights, block_q6_K: 210). The CUDA kernels
read these blocks directly; the plain dequantizers below are their
reference and the CPU path.

Stacked MoE experts are one wire tensor of logical shape [n_exp, N, K]
whose blocks are ``[n_exp * N, row_bytes]``, expert e's rows at
``e*N .. e*N+N-1`` (the file's own order); only the selected experts'
blocks are ever decoded (:func:`dequantize_experts`).

The dequantizers repeat decode_np's arithmetic operation for operation in
f32, so they are bit-exact against it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..gguf import GGMLType

QK_K = 256
BLOCK_BYTES = {"Q4_K": 144, "Q6_K": 210}
_KIND_OF = {GGMLType.Q4_K: "Q4_K", GGMLType.Q6_K: "Q6_K"}
DENSE_TYPES = (GGMLType.F32, GGMLType.F16, GGMLType.BF16)


@dataclass
class WireTensor:
    """A block-quantized [N, K] weight, or a stack of experts [n_exp, N, K]:
    kind, logical shape, wire blocks, and optionally the int8 prefill
    planes of quant/mmq.py (qi8 int8 [N, K], ws8T f32 [K / 512, N])."""

    kind: str
    shape: tuple[int, ...]
    blocks: torch.Tensor  # uint8 [prod(shape[:-1]), (K // 256) * BLOCK_BYTES[kind]]
    qi8: torch.Tensor | None = None
    ws8T: torch.Tensor | None = None

    def __post_init__(self):
        if self.kind not in BLOCK_BYTES:
            raise NotImplementedError(f"quant kind {self.kind} is not ported yet")
        if len(self.shape) not in (2, 3):
            raise ValueError(f"{self.kind}: shape {self.shape} is neither [N, K] nor "
                             "[n_exp, N, K]")
        k = self.shape[-1]
        if k % QK_K:
            raise ValueError(f"{self.kind}: K={k} is not a multiple of {QK_K}")
        want = (int(np.prod(self.shape[:-1])), k // QK_K * BLOCK_BYTES[self.kind])
        if self.blocks.dtype != torch.uint8 or tuple(self.blocks.shape) != want:
            raise ValueError(f"{self.kind} blocks must be uint8 {want}, got "
                             f"{self.blocks.dtype} {tuple(self.blocks.shape)}")
        if (self.qi8 is None) != (self.ws8T is None):
            raise ValueError("the int8 planes qi8 and ws8T come together")
        if self.qi8 is not None:
            n, k = self.shape if len(self.shape) == 2 else (0, 0)
            if (self.qi8.dtype != torch.int8 or tuple(self.qi8.shape) != (n, k)
                    or self.ws8T.dtype != torch.float32 or self.ws8T.dim() != 2
                    or self.ws8T.shape[1] != n or k % self.ws8T.shape[0]):
                raise ValueError(f"int8 planes of a {self.shape} weight must be qi8 int8 "
                                 f"[N, K] and ws8T f32 [groups, N], got {self.qi8.dtype} "
                                 f"{tuple(self.qi8.shape)}, {self.ws8T.dtype} "
                                 f"{tuple(self.ws8T.shape)}")

    @property
    def device(self) -> torch.device:
        return self.blocks.device

    @property
    def nbytes(self) -> int:
        """Bytes of the wire blocks (the int8 planes are not counted)."""
        return self.blocks.numel()

    def to(self, device) -> "WireTensor":
        planes = (None, None) if self.qi8 is None else (self.qi8.to(device),
                                                         self.ws8T.to(device))
        return WireTensor(self.kind, self.shape, self.blocks.to(device), *planes)


def kind_of(ggml_type: GGMLType) -> str:
    kind = _KIND_OF.get(GGMLType(ggml_type))
    if kind is None:
        raise NotImplementedError(
            f"quantized type {GGMLType(ggml_type).name} is not ported yet "
            "(the port carries Q4_K and Q6_K)")
    return kind


def from_bytes(data, ggml_type, shape, device=None) -> WireTensor:
    """A quantized GGUF tensor (raw block bytes, numpy shape [N, K], or
    [n_exp, N, K] for stacked experts)."""
    kind = kind_of(ggml_type)
    if len(shape) not in (2, 3):
        raise NotImplementedError(f"{len(shape)}-D quantized tensors are not ported yet")
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape[:-1]))
    raw = np.frombuffer(np.ascontiguousarray(data, dtype=np.uint8), np.uint8)
    row_bytes = shape[-1] // QK_K * BLOCK_BYTES[kind]
    blocks = torch.from_numpy(raw[: n * row_bytes].copy()).reshape(n, row_bytes)
    return WireTensor(kind, shape, blocks.to(device) if device is not None else blocks)


def dense_from_bytes(data, ggml_type, shape) -> np.ndarray:
    """F32/F16/BF16 GGUF tensor bytes -> float32 numpy array of `shape`."""
    t = GGMLType(ggml_type)
    raw = np.ascontiguousarray(data, dtype=np.uint8).reshape(-1)
    n = int(np.prod(shape))
    if t == GGMLType.F32:
        out = raw[: 4 * n].view("<f4").astype(np.float32)
    elif t == GGMLType.F16:
        out = raw[: 2 * n].view("<f2").astype(np.float32)
    elif t == GGMLType.BF16:
        out = (raw[: 2 * n].view("<u2").astype(np.uint32) << 16).view(np.float32)
    else:
        raise ValueError(f"{t.name} is not a dense type")
    return out.reshape(shape)


def _f16_at(b: torch.Tensor, off: int) -> torch.Tensor:
    """Little-endian f16 field at byte `off` of each block -> f32 [M, 1]."""
    return b[:, off : off + 2].contiguous().view(torch.float16).float()


def _k4_scale_min(s: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[M, 12] packed 6-bit (scale, min) pairs -> two uint8 [M, 8]."""
    sc = torch.cat([s[:, 0:4] & 63, (s[:, 8:12] & 0xF) | ((s[:, 0:4] >> 6) << 4)], dim=1)
    mn = torch.cat([s[:, 4:8] & 63, (s[:, 8:12] >> 4) | ((s[:, 4:8] >> 6) << 4)], dim=1)
    return sc, mn


def dequant_q4_k(b: torch.Tensor) -> torch.Tensor:
    """uint8 [M, 144] blocks -> f32 [M, 256] (decode_np.dequant_q4_K)."""
    d, dmin = _f16_at(b, 0), _f16_at(b, 2)
    sc, mn = _k4_scale_min(b[:, 4:16])
    qs = b[:, 16:144].reshape(-1, 4, 1, 32)
    q = torch.cat([qs & 0xF, qs >> 4], dim=2).reshape(-1, 256).float()
    dl = (d * sc.float()).repeat_interleave(32, dim=1)
    ml = (dmin * mn.float()).repeat_interleave(32, dim=1)
    return dl * q - ml


_Q6_SHIFTS = (0, 2, 4, 6)


def dequant_q6_k(b: torch.Tensor) -> torch.Tensor:
    """uint8 [M, 210] blocks -> f32 [M, 256] (decode_np.dequant_q6_K).
    Element e: chunk e//128, quarter (e%128)//32, l = e%32."""
    ql = b[:, 0:128].reshape(-1, 2, 2, 32)          # [M, chunk, half, l]
    nib = torch.cat([ql & 0xF, ql >> 4], dim=2)     # quarters 0, 1, 2, 3
    qh = b[:, 128:192].reshape(-1, 2, 1, 32)
    hb = torch.cat([(qh >> s) & 3 for s in _Q6_SHIFTS], dim=2)
    q = ((nib.to(torch.int16) | (hb.to(torch.int16) << 4)) - 32).reshape(-1, 256).float()
    scales = b[:, 192:208].contiguous().view(torch.int8).float()
    dl = (_f16_at(b, 208) * scales).repeat_interleave(16, dim=1)
    return dl * q


_DEQUANT = {"Q4_K": dequant_q4_k, "Q6_K": dequant_q6_k}


def dequantize(w: WireTensor, dtype=torch.float32) -> torch.Tensor:
    """The full weight of w.shape, computed in f32 then cast to `dtype`."""
    out = _DEQUANT[w.kind](w.blocks.reshape(-1, BLOCK_BYTES[w.kind]))
    return out.reshape(w.shape).to(dtype)


def dequantize_rows(w: WireTensor, idx: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """dequantize(w)[idx] without decoding the whole table: the rows' blocks
    are gathered first (the token-embedding lookup; planar.decode_rows).
    Returns [*idx.shape, K]."""
    rows = w.blocks.index_select(0, idx.reshape(-1).to(w.device))
    sub = WireTensor(w.kind, (rows.shape[0], w.shape[1]), rows)
    return dequantize(sub, dtype).reshape(*idx.shape, w.shape[1])


def dequantize_experts(w: WireTensor, ids: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """dequantize(w)[ids] for a stack [n_exp, N, K]: the selected experts'
    blocks are gathered first and only those are decoded (the counterpart
    of qmm_id.qmm_gather_xla's plane gather). Returns [*ids.shape, N, K]."""
    n_exp, n, k = w.shape
    sel = w.blocks.reshape(n_exp, n, -1).index_select(0, ids.reshape(-1).to(w.device))
    sub = WireTensor(w.kind, (sel.shape[0] * n, k), sel.reshape(-1, sel.shape[-1]))
    return dequantize(sub, dtype).reshape(*ids.shape, n, k)


def fuse_experts(gate: WireTensor, up: WireTensor) -> WireTensor | None:
    """Per-expert [gate; up] fusion of two stacks [n_exp, F, K] into one
    [n_exp, 2F, K]: every expert's gate rows, then its up rows, so one
    expert gather streams both products (models/loader.py's
    ffn_gate_up_exps). None unless both are stacks of one kind and shape."""
    if not (isinstance(gate, WireTensor) and isinstance(up, WireTensor)
            and gate.kind == up.kind and gate.shape == up.shape and len(gate.shape) == 3):
        return None
    n_exp, f, k = gate.shape
    blocks = torch.cat([gate.blocks.reshape(n_exp, f, -1), up.blocks.reshape(n_exp, f, -1)],
                       dim=1)
    return WireTensor(gate.kind, (n_exp, 2 * f, k), blocks.reshape(n_exp * 2 * f, -1))


def fuse_rows(ws: list) -> "WireTensor | torch.Tensor | None":
    """Concatenate weights along N so one product serves several (the
    loader's q/k/v, q/k and gate/up fusion). Wire tensors fuse by a row
    concatenation of their block bytes; only same-kind tensors (or dense
    tensors of one dtype) with equal K fuse."""
    if all(isinstance(w, WireTensor) for w in ws):
        if len({w.kind for w in ws}) != 1 or len({w.shape[1] for w in ws}) != 1:
            return None
        blocks = torch.cat([w.blocks for w in ws], dim=0)
        return WireTensor(ws[0].kind, (blocks.shape[0], ws[0].shape[1]), blocks)
    if all(isinstance(w, torch.Tensor) for w in ws):
        if len({w.shape[-1] for w in ws}) != 1 or len({w.dtype for w in ws}) != 1:
            return None
        return torch.cat(ws, dim=0)
    return None
