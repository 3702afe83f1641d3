"""Quantized weights in GGUF wire format on the device.

Counterpart of llamacog_tpu/quant/planar.py and the K-quant decoders of
quant/decode_np.py. The planar layout exists for the TPU (lane-aligned
unpack, group-strided columns, f32 scale planes, transposed superblock
planes); none of its reasons hold on a GPU, so a weight stays here exactly
as the file stores it: a ``uint8 [N, row_bytes]`` tensor of ggml blocks
(per 256 weights: block_q2_K 84 bytes, block_q3_K 110, block_q4_K 144,
block_q5_K 176, block_q6_K 210; the codebook kinds block_iq4_xs 136,
block_iq3_xxs 98, block_iq3_s 110, block_iq2_s 82, block_iq2_xxs 66,
block_iq2_xs 74, block_iq1_s 50, block_iq1_m 56; the ternary block_tq1_0 54
and block_tq2_0 66). The legacy blocks hold 32 weights each (block_q4_0 18
bytes, q4_1 20, q5_0 22, q5_1 24, q8_0 34, iq4_nl 18), so 256 weights take
eight of them (144, 160, 176, 192, 272, 144 bytes) and a row of K weights
is K / 256 such runs, as for the K-quants. The IQ kinds' levels come from
the tables of quant/iq_tables.py.
The CUDA kernels read these blocks directly; the plain dequantizers below
are their reference and the CPU path.

Stacked MoE experts are one wire tensor of logical shape [n_exp, N, K]
whose blocks are ``[n_exp * N, row_bytes]``, expert e's rows at
``e*N .. e*N+N-1`` (the file's own order); only the selected experts'
blocks are ever decoded (:func:`dequantize_experts`), unless the caller
kept the whole decode (:func:`keep_decoded`).

The dequantizers repeat decode_np's arithmetic operation for operation in
f32, so they are bit-exact against it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..gguf import GGMLType
from . import iq_tables

QK_K = 256
# wire bytes per QK_K weights (the legacy kinds: eight 32-weight blocks)
BLOCK_BYTES = {"Q4_K": 144, "Q6_K": 210, "Q8_0": 272, "Q5_K": 176, "Q4_0": 144, "Q4_1": 160,
               "Q5_0": 176, "Q5_1": 192, "Q2_K": 84, "Q3_K": 110, "IQ4_NL": 144, "IQ4_XS": 136,
               "IQ3_XXS": 98, "IQ3_S": 110, "IQ2_S": 82, "IQ2_XXS": 66, "IQ2_XS": 74,
               "IQ1_S": 50, "IQ1_M": 56, "TQ1_0": 54, "TQ2_0": 66}
_KIND_OF = {getattr(GGMLType, kind): kind for kind in BLOCK_BYTES}
DENSE_TYPES = (GGMLType.F32, GGMLType.F16, GGMLType.BF16)


@dataclass
class WireTensor:
    """A block-quantized [N, K] weight, or a stack of experts [n_exp, N, K]:
    kind, logical shape, wire blocks, and optionally the int8 prefill
    planes of quant/mmq.py (qi8 int8 [N, K], ws8T f32 [K / 512, N]), and
    optionally `decoded`, the plain dequant of the whole weight (f32 of
    `shape`), which the plain dequantizers then read instead of decoding
    the blocks again (:func:`keep_decoded`)."""

    kind: str
    shape: tuple[int, ...]
    blocks: torch.Tensor  # uint8 [prod(shape[:-1]), (K // 256) * BLOCK_BYTES[kind]]
    qi8: torch.Tensor | None = None
    ws8T: torch.Tensor | None = None
    decoded: torch.Tensor | None = None

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
        if self.decoded is not None and (self.decoded.dtype != torch.float32
                                         or tuple(self.decoded.shape) != self.shape):
            raise ValueError(f"the decoded weight of a {self.shape} weight must be f32 of its "
                             f"shape, got {self.decoded.dtype} {tuple(self.decoded.shape)}")

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
        decoded = None if self.decoded is None else self.decoded.to(device)
        return WireTensor(self.kind, self.shape, self.blocks.to(device), *planes, decoded)


def kind_of(ggml_type: GGMLType) -> str:
    kind = _KIND_OF.get(GGMLType(ggml_type))
    if kind is None:
        raise NotImplementedError(
            f"quantized type {GGMLType(ggml_type).name} is not ported yet "
            f"(the port carries {', '.join(BLOCK_BYTES)})")
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


def dequant_q5_k(b: torch.Tensor) -> torch.Tensor:
    """uint8 [M, 176] blocks -> f32 [M, 256] (decode_np.dequant_q5_K): Q4_K's
    nibbles plus a fifth bit, element e taking bit e//32 of qh[e%32]."""
    d, dmin = _f16_at(b, 0), _f16_at(b, 2)
    sc, mn = _k4_scale_min(b[:, 4:16])
    qh = b[:, 16:48].reshape(-1, 1, 32)
    hb = torch.cat([(qh >> s) & 1 for s in range(8)], dim=1).reshape(-1, 256)
    qs = b[:, 48:176].reshape(-1, 4, 1, 32)
    q = (torch.cat([qs & 0xF, qs >> 4], dim=2).reshape(-1, 256) | (hb << 4)).float()
    dl = (d * sc.float()).repeat_interleave(32, dim=1)
    ml = (dmin * mn.float()).repeat_interleave(32, dim=1)
    return dl * q - ml


def dequant_q8_0(b: torch.Tensor) -> torch.Tensor:
    """uint8 [M, 272] (eight 34-byte blocks: f16 d, 32 int8) -> f32 [M, 256]
    (decode_np.dequant_q8_0)."""
    blk = b.reshape(-1, 34)
    q = blk[:, 2:34].contiguous().view(torch.int8).float()
    return (q * _f16_at(blk, 0)).reshape(-1, 256)


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


def _nibbles(qs: torch.Tensor) -> torch.Tensor:
    """[M, 16] packed bytes of a legacy block -> [M, 32] codes: element j
    the low nibble of byte j, element 16 + j its high nibble."""
    return torch.cat([qs & 0xF, qs >> 4], dim=1)


def _bits32(qh: torch.Tensor) -> torch.Tensor:
    """[M, 4] little-endian bytes of a u32 -> [M, 32] its bits, bit j at j."""
    return torch.cat([(qh[:, k : k + 1] >> s) & 1 for k in range(4) for s in range(8)], dim=1)


def dequant_q4_0(b: torch.Tensor) -> torch.Tensor:
    """uint8 [M, 144] (eight 18-byte blocks: f16 d, 16 nibble bytes) -> f32
    [M, 256] (decode_np.dequant_q4_0: (q - 8) * d)."""
    blk = b.reshape(-1, 18)
    q = (_nibbles(blk[:, 2:18]).to(torch.int16) - 8).float()
    return (q * _f16_at(blk, 0)).reshape(-1, 256)


def dequant_q4_1(b: torch.Tensor) -> torch.Tensor:
    """uint8 [M, 160] (eight 20-byte blocks: f16 d, f16 m, 16 nibble bytes)
    -> f32 [M, 256] (decode_np.dequant_q4_1: q * d + m)."""
    blk = b.reshape(-1, 20)
    q = _nibbles(blk[:, 4:20]).float()
    return (q * _f16_at(blk, 0) + _f16_at(blk, 2)).reshape(-1, 256)


def dequant_q5_0(b: torch.Tensor) -> torch.Tensor:
    """uint8 [M, 176] (eight 22-byte blocks: f16 d, u32 qh, 16 nibble bytes)
    -> f32 [M, 256] (decode_np.dequant_q5_0: element j takes bit j of qh as
    its fifth bit; (q - 16) * d)."""
    blk = b.reshape(-1, 22)
    q = _nibbles(blk[:, 6:22]).to(torch.int16) | (_bits32(blk[:, 2:6]).to(torch.int16) << 4)
    return ((q - 16).float() * _f16_at(blk, 0)).reshape(-1, 256)


def dequant_q5_1(b: torch.Tensor) -> torch.Tensor:
    """uint8 [M, 192] (eight 24-byte blocks: f16 d, f16 m, u32 qh, 16 nibble
    bytes) -> f32 [M, 256] (decode_np.dequant_q5_1: q * d + m)."""
    blk = b.reshape(-1, 24)
    q = (_nibbles(blk[:, 8:24]) | (_bits32(blk[:, 4:8]) << 4)).float()
    return (q * _f16_at(blk, 0) + _f16_at(blk, 2)).reshape(-1, 256)


def _crumbs(qs: torch.Tensor) -> torch.Tensor:
    """[M, 64] packed 2-bit codes -> [M, 256]: element e is bits 2s, 2s + 1
    of byte 32c + l, where c = e // 128, s = (e % 128) // 32, l = e % 32
    (decode_np._unpack_2bit_qk)."""
    q = qs.reshape(-1, 2, 1, 32)
    return torch.cat([(q >> (2 * s)) & 3 for s in range(4)], dim=2).reshape(-1, 256)


def dequant_q2_k(b: torch.Tensor) -> torch.Tensor:
    """uint8 [M, 84] blocks (scales[16]: 4-bit scale | 4-bit min of each 16
    weights; qs[64]; f16 d; f16 dmin) -> f32 [M, 256]
    (decode_np.dequant_q2_K: (d * sc) * q - dmin * m)."""
    sc = b[:, 0:16]
    q = _crumbs(b[:, 16:80]).float()
    dl = (_f16_at(b, 80) * (sc & 0xF).float()).repeat_interleave(16, dim=1)
    ml = (_f16_at(b, 82) * (sc >> 4).float()).repeat_interleave(16, dim=1)
    return dl * q - ml


def _q3_scales(s: torch.Tensor) -> torch.Tensor:
    """[M, 12] packed 6-bit scales -> [M, 16] in 0..63 (decode_np._q3_scales):
    scale g takes the low nibble of byte g (g < 8) or the high nibble of
    byte g - 8, and bits 2 (g // 4), +1 of byte 8 + g % 4 as its top two."""
    lo = torch.cat([s[:, 0:8] & 0xF, s[:, 0:8] >> 4], dim=1)
    hi = torch.cat([(s[:, 8:12] >> (2 * j)) & 3 for j in range(4)], dim=1)
    return lo | (hi << 4)


def dequant_q3_k(b: torch.Tensor) -> torch.Tensor:
    """uint8 [M, 110] blocks (hmask[32], qs[64], scales[12], f16 d) -> f32
    [M, 256] (decode_np.dequant_q3_K): element e has the 2-bit code of
    _crumbs, minus 4 where bit e // 32 of hmask[e % 32] is clear, times
    d * (scale - 32)."""
    hm = b[:, 0:32].reshape(-1, 1, 32)
    hb = torch.cat([(hm >> s) & 1 for s in range(8)], dim=1).reshape(-1, 256)
    q = (_crumbs(b[:, 32:96]).to(torch.int16) + 4 * hb.to(torch.int16) - 4).float()
    scales = _q3_scales(b[:, 96:108]).float() - 32.0
    dl = (_f16_at(b, 108) * scales).repeat_interleave(16, dim=1)
    return dl * q


def _u32_at(b: torch.Tensor, off: int, n: int) -> torch.Tensor:
    """n little-endian u32 fields from byte `off` of each block -> int64 [M, n]."""
    w = b[:, off : off + 4 * n].to(torch.int64).reshape(-1, n, 4)
    return w[..., 0] | (w[..., 1] << 8) | (w[..., 2] << 16) | (w[..., 3] << 24)


def _u16_at(b: torch.Tensor, off: int, n: int) -> torch.Tensor:
    """n little-endian u16 fields from byte `off` of each block -> int64 [M, n]."""
    w = b[:, off : off + 2 * n].to(torch.int64).reshape(-1, n, 2)
    return w[..., 0] | (w[..., 1] << 8)


def _iq4_levels(qs: torch.Tensor) -> torch.Tensor:
    """[M, G, 16] nibble bytes -> [M, G, 32] levels kvalues_iq4nl[q]: element
    j < 16 the low nibble of byte j, 16 + j its high nibble."""
    kvalues = iq_tables.tables(qs.device)["kvalues"]
    return kvalues[torch.cat([qs & 0xF, qs >> 4], dim=-1).long()]


def _iq2_scales(d: torch.Tensor, sc: torch.Tensor) -> torch.Tensor:
    """IQ2_XS / IQ2_S: [M, 8] scale bytes -> [M, 16] d * (0.5 + nibble) *
    0.25, the low nibble of byte ib for elements 0-15 of sub-block ib, the
    high one for 16-31."""
    return torch.stack([d * (0.5 + (sc & 0xF).float()) * 0.25,
                        d * (0.5 + (sc >> 4).float()) * 0.25], dim=-1).reshape(-1, 16)


IQ1_DELTA = 0.125  # IQ1S_DELTA, IQ1M_DELTA (ggml-common.h)


def _trits(v: torch.Tensor, j: int) -> torch.Tensor:
    """TQ1_0's base-3 digit j (0..4) of each byte: ((v * 3^j) mod 256) * 3 >> 8."""
    return ((v * 3**j) & 0xFF) * 3 >> 8


def iq_levels(kind: str, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The codebook and ternary kinds' blocks uint8 [M, BLOCK_BYTES[kind]] ->
    (levels f32 [M, 256], scales f32 [M, P]): every weight is scale * level,
    its part's scale (P = 16 parts of 16 weights for IQ2_S, IQ2_XS and IQ1_M,
    else 8 of 32) times a small exact level (a kvalues_iq4nl entry, a grid
    byte times its sign, an iq1s level plus or minus IQ1_DELTA, or a trit
    minus 1), each scale formed as decode_np forms it:
    - IQ4_NL, eight 18-byte blocks (f16 d, 16 nibble bytes): d, kvalues[q];
    - IQ4_XS (f16 d, u16 scales_h, scales_l[4], qs[128]): sub-block ib's
      6-bit scale is nibble ib of scales_l with bits 2ib, 2ib + 1 of scales_h
      on top; d * (ls - 32), kvalues[q], the codes as IQ4_NL's;
    - IQ3_XXS (f16 d, qs[64] grid indices, 8 u32 of four 7-bit sign indices
      and a 4-bit scale s): group l of sub-block ib takes grid entries
      qs[8ib + 2l], qs[8ib + 2l + 1] of iq3xxs (4 levels each) and the signs
      ksigns[(u32 >> 7l) & 127]; d * (0.5 + s) * 0.5;
    - IQ3_S (f16 d, qs[64], qh[8], signs[32], scales[4]): byte m of sub-block
      ib takes entry qs[8ib + m] | (bit m of qh[ib]) << 8 of iq3s and sign
      bits 4(m % 2).. of signs[4ib + m // 2]; d * (1 + 2 nibble ib);
    - IQ2_S (f16 d, qs[32], signs[32], qh[8], scales[8]): group l of
      sub-block ib takes entry qs[4ib + l] | (bits 2l, 2l + 1 of qh[ib]) << 8
      of iq2s and signs[4ib + l]; d * (0.5 + nibble) * 0.25, the low nibble
      of scales[ib] for groups 0-1, the high one for 2-3;
    - IQ2_XXS (f16 d, per sub-block two u32: four grid indices as bytes;
      four 7-bit sign indices and a 4-bit scale s): group l takes entry
      byte l of iq2xxs and ksigns[(u32 >> 7l) & 127]; d * (0.5 + s) * 0.25;
    - IQ2_XS (f16 d, qs[32] u16, scales[8]): group l of sub-block ib takes
      entry u16 & 511 of iq2xs and ksigns[u16 >> 9] (u16 = qs[4ib + l]); the
      scales as IQ2_S's;
    - IQ1_S (f16 d, qs[32], qh[8] u16): group l of sub-block ib takes entry
      qs[4ib + l] | (bits 3l..3l + 2 of qh[ib]) << 8 of iq1s, + IQ1_DELTA,
      - IQ1_DELTA where bit 15 of qh[ib] is set; d * (2 s + 1), s = bits
      12-14 of qh[ib];
    - IQ1_M (qs[32], qh[16], four u16 scale words whose top nibbles hold the
      f16 d): group l takes entry qs[4ib + l] with the low (l even) or high
      (l odd) three bits of qh[2ib + l // 2] on top, the delta's sign its
      bit 3 or 7; the scale of groups 0-1 (2-3) of sub-block ib is d * (2 s
      + 1), s the 3-bit field 6 (ib % 2) (+ 3) of scale word ib // 2;
    - TQ1_0 (qs[48], qh[4], f16 d): base-3 digit j of a byte is ((v * 3^j)
      mod 256) * 3 >> 8; elements 0-159 are digits 0-4 of qs[0:32] (32 a
      digit), 160-239 of qs[32:48] (16 a digit), 240-255 digits 0-3 of qh
      (4 a digit); d, q - 1;
    - TQ2_0 (qs[64], f16 d): element 128h + 32j + m is bits 2j, 2j + 1 of
      qs[32h + m]; d, q - 1.
    decode_np forms (scale * grid) * sign: the sign is exact, so the product
    rounds alike."""
    t, dev = iq_tables.tables(b.device), b.device
    if kind == "IQ4_NL":
        blk = b.reshape(-1, 18)
        return (_iq4_levels(blk[:, 2:18]).reshape(-1, 256), _f16_at(blk, 0).reshape(-1, 8))
    if kind == "IQ1_M":
        scb = _u16_at(b, 48, 4)
        d16 = ((scb[:, 0] >> 12) | ((scb[:, 1] >> 8) & 0xF0) | ((scb[:, 2] >> 4) & 0xF00)
               | (scb[:, 3] & 0xF000))
        d = ((d16 ^ 0x8000) - 0x8000).to(torch.int16).view(torch.float16).float()[:, None, None]
        ib = torch.arange(8, device=dev)
        s = scb[:, ib // 2] >> (6 * (ib % 2))                                  # [M, 8]
        dl = torch.stack([2 * (s & 7).float() + 1, 2 * ((s >> 3) & 7).float() + 1], dim=-1)
        qh = b[:, 32:48].reshape(-1, 8, 2).long()[:, :, [0, 0, 1, 1]]          # [M, 8, 4]
        idx = b[:, 0:32].reshape(-1, 8, 4).long() | (
            (qh << torch.tensor([8, 4, 8, 4], device=dev)) & 0x700)
        neg = (qh & torch.tensor([0x08, 0x80, 0x08, 0x80], device=dev)) != 0
        levels = t["iq1s"][idx] + torch.where(neg, -IQ1_DELTA, IQ1_DELTA)[..., None]
        return levels.reshape(-1, 256), (d * dl).reshape(-1, 16)
    if kind == "TQ1_0":
        qs, qh = b[:, 0:48].long(), b[:, 48:52].long()
        q = torch.cat([_trits(qs[:, 0:32], j) for j in range(5)]
                      + [_trits(qs[:, 32:48], j) for j in range(5)]
                      + [_trits(qh, j) for j in range(4)], dim=1)
        return q.float() - 1, _f16_at(b, 52).expand(-1, 8)
    if kind == "TQ2_0":
        q = torch.cat([(b[:, 32 * h : 32 * h + 32] >> (2 * j)) & 3
                       for h in range(2) for j in range(4)], dim=1)
        return q.float() - 1, _f16_at(b, 64).expand(-1, 8)
    d = _f16_at(b, 0)
    if kind == "IQ4_XS":
        sh = b[:, 2].long() | (b[:, 3].long() << 8)
        sl = b[:, 4:8].long()
        ib = torch.arange(8, device=dev)
        ls = ((sl[:, ib // 2] >> (4 * (ib % 2))) & 0xF) | (((sh[:, None] >> (2 * ib)) & 3) << 4)
        return _iq4_levels(b[:, 8:136].reshape(-1, 8, 16)).reshape(-1, 256), d * (ls.float() - 32.0)
    if kind == "IQ3_XXS":
        qs = b[:, 2:66].reshape(-1, 8, 4, 2).long()
        sas = _u32_at(b, 66, 8)                                            # [M, 8]
        s7 = (sas[..., None] >> (7 * torch.arange(4, device=dev))) & 127   # [M, 8, 4]
        levels = t["iq3xxs"][qs].reshape(-1, 8, 4, 8) * t["sign128"][s7]
        return levels.reshape(-1, 256), d * (0.5 + (sas >> 28).float()) * 0.5
    if kind == "IQ3_S":
        ib = torch.arange(8, device=dev)
        idx = b[:, 2:66].reshape(-1, 8, 8).long() | (((b[:, 66:74, None].long() >> ib) & 1) << 8)
        signs = t["sign256"][b[:, 74:106].reshape(-1, 8, 4).long()].reshape(-1, 8, 8, 4)
        nib = (b[:, 106:110].long()[:, ib // 2] >> (4 * (ib % 2))) & 0xF
        return (t["iq3s"][idx] * signs).reshape(-1, 256), d * (1 + 2 * nib.float())
    if kind == "IQ2_S":
        shift = 8 - 2 * torch.arange(4, device=dev)
        idx = b[:, 2:34].reshape(-1, 8, 4).long() | ((b[:, 66:74, None].long() << shift) & 0x300)
        levels = t["iq2s"][idx] * t["sign256"][b[:, 34:66].reshape(-1, 8, 4).long()]
        return levels.reshape(-1, 256), _iq2_scales(d, b[:, 74:82])
    if kind == "IQ2_XXS":
        u = _u32_at(b, 2, 16).reshape(-1, 8, 2)
        sh = torch.arange(4, device=dev)
        idx, s7 = (u[..., 0:1] >> (8 * sh)) & 0xFF, (u[..., 1:2] >> (7 * sh)) & 127
        levels = t["iq2xxs"][idx] * t["sign128"][s7]
        return levels.reshape(-1, 256), d * (0.5 + (u[..., 1] >> 28).float()) * 0.25
    if kind == "IQ2_XS":
        qs = _u16_at(b, 2, 32).reshape(-1, 8, 4)
        levels = t["iq2xs"][qs & 511] * t["sign128"][qs >> 9]
        return levels.reshape(-1, 256), _iq2_scales(d, b[:, 66:74])
    if kind == "IQ1_S":
        qh = _u16_at(b, 34, 8)                                             # [M, 8]
        idx = b[:, 2:34].reshape(-1, 8, 4).long() | (
            ((qh[..., None] >> (3 * torch.arange(4, device=dev))) & 7) << 8)
        levels = t["iq1s"][idx] + torch.where((qh & 0x8000) != 0, -IQ1_DELTA,
                                              IQ1_DELTA)[..., None, None]
        return levels.reshape(-1, 256), d * (2 * ((qh >> 12) & 7).float() + 1)
    raise ValueError(f"{kind} is not a codebook or ternary kind")


# the codebook kinds of 2.5 to 4.5 bits a weight, the 1.5 to 2.3 bit
# codebook kinds with the ternary ones, and both together: the kinds whose
# plain dequant is scale * level (iq_levels; the kernels' sets of
# csrc/common.cuh::kind_iq, kind_iq_low and kind_signed)
CODEBOOK_KINDS = ("IQ4_NL", "IQ4_XS", "IQ3_XXS", "IQ3_S", "IQ2_S")
LOW_BIT_KINDS = ("IQ2_XXS", "IQ2_XS", "IQ1_S", "IQ1_M", "TQ1_0", "TQ2_0")
IQ_LEVEL_KINDS = CODEBOOK_KINDS + LOW_BIT_KINDS


def _dequant_iq(kind: str):
    def dequant(b: torch.Tensor) -> torch.Tensor:
        levels, scales = iq_levels(kind, b)
        return scales.repeat_interleave(256 // scales.shape[1], dim=1) * levels
    dequant.__doc__ = f"uint8 [M, {BLOCK_BYTES[kind]}] -> f32 [M, 256] (iq_levels)"
    return dequant


_DEQUANT = {"Q4_K": dequant_q4_k, "Q6_K": dequant_q6_k, "Q8_0": dequant_q8_0,
            "Q5_K": dequant_q5_k, "Q4_0": dequant_q4_0, "Q4_1": dequant_q4_1,
            "Q5_0": dequant_q5_0, "Q5_1": dequant_q5_1, "Q2_K": dequant_q2_k,
            "Q3_K": dequant_q3_k, **{kind: _dequant_iq(kind) for kind in IQ_LEVEL_KINDS}}


def dequantize(w: WireTensor, dtype=torch.float32) -> torch.Tensor:
    """The full weight of w.shape, computed in f32 then cast to `dtype`; a
    new tensor, which the caller may write to (quant/mmq.py does)."""
    if w.decoded is not None:
        return w.decoded.to(dtype, copy=True)
    out = _DEQUANT[w.kind](w.blocks.reshape(-1, BLOCK_BYTES[w.kind]))
    return out.reshape(w.shape).to(dtype)


def keep_decoded(w: WireTensor) -> WireTensor:
    """w with its plain dequant kept beside the blocks: a plain-path copy of
    a model that runs many steps decodes each weight once, not once a step
    (4 bytes a weight; a stack is then held decoded whole). The values the
    plain dequantizers return do not change: each superblock decodes alone."""
    if w.decoded is not None:
        return w
    return WireTensor(w.kind, w.shape, w.blocks, w.qi8, w.ws8T, dequantize(w))


def dequantize_rows(w: WireTensor, idx: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """dequantize(w)[idx] without decoding the whole table: the rows' blocks
    are gathered first (the token-embedding lookup; planar.decode_rows).
    Returns [*idx.shape, K]."""
    if w.decoded is not None:
        rows = w.decoded.index_select(0, idx.reshape(-1).to(w.device))
        return rows.to(dtype).reshape(*idx.shape, w.shape[1])
    rows = w.blocks.index_select(0, idx.reshape(-1).to(w.device))
    sub = WireTensor(w.kind, (rows.shape[0], w.shape[1]), rows)
    return dequantize(sub, dtype).reshape(*idx.shape, w.shape[1])


def dequantize_experts(w: WireTensor, ids: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """dequantize(w)[ids] for a stack [n_exp, N, K]: the selected experts'
    blocks are gathered first and only those are decoded (the counterpart
    of qmm_id.qmm_gather_xla's plane gather). Returns [*ids.shape, N, K]."""
    n_exp, n, k = w.shape
    if w.decoded is not None:
        sel = w.decoded.index_select(0, ids.reshape(-1).to(w.device))
        return sel.to(dtype).reshape(*ids.shape, n, k)
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
