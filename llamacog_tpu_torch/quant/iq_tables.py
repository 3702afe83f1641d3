"""The codebook tables of the IQ wire kinds, for the plain dequant and the
CUDA kernels.

``iq_grids.npz`` beside this module is the port's own copy of the tables of
ggml-common.h (kvalues_iq4nl, the iq3xxs / iq3s / iq2xxs / iq2xs / iq2s /
iq1s grids, ksigns_iq2xs). The plain dequant (quant/wire.py) takes them as
f32 tensors: each grid entry is 4 or 8 unsigned byte levels (iq1s: 8
signed levels -1, 0, 1), and a sign byte's bit j negates level j
(ksigns_iq2xs maps a 7-bit sign index to such a byte: the index with its
parity as bit 7).

The kernels take them from :func:`cuda_header`, which ops/cuda/build.py
writes into the build directory as ``iq_tables.cuh`` before it compiles:
the grids as ``__device__`` word arrays (read through L1; iq1s packed as
llama.cpp's iq1s_grid_gpu packs it, level + 1 as a nibble, one word an
entry), and the 16 IQ4 levels plus 128 as four byte-permute words
(IQ4NL_X80_0..3, held in registers). The sign bytes are computed from the
parity, so no ksigns table reaches the device.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import torch

NPZ = Path(__file__).with_name("iq_grids.npz")


@functools.lru_cache(maxsize=None)
def raw() -> dict:
    """The npz arrays as stored (grid entries packed little-endian into
    uint32 / uint64 words)."""
    with np.load(NPZ) as z:
        return {k: z[k].copy() for k in z.files}


def _grid(name: str, values: int, dtype=np.uint8) -> torch.Tensor:
    return torch.from_numpy(raw()[name].view(dtype).reshape(-1, values).astype(np.float32))


def _signs(bytes_: np.ndarray) -> torch.Tensor:
    """[n, 8] f32: -1 where bit j of sign byte n is set, else 1."""
    bits = (bytes_.astype(np.uint16)[:, None] >> np.arange(8)) & 1
    return torch.from_numpy(np.where(bits == 1, -1.0, 1.0).astype(np.float32))


def tables(device=None) -> dict:
    """f32 tensors on `device` (default the CPU) for the plain dequant:
    kvalues [16], iq3xxs [256, 4], iq3s [512, 4], iq2xxs [256, 8], iq2xs
    [512, 8], iq2s [1024, 8], iq1s [2048, 8] (signed levels), sign128 [128,
    8] (by 7-bit sign index), sign256 [256, 8] (by raw sign byte)."""
    return _tables(str(torch.device(device if device is not None else "cpu")))


@functools.lru_cache(maxsize=None)
def _tables(device: str) -> dict:
    t = {
        "kvalues": torch.from_numpy(raw()["kvalues_iq4nl"].astype(np.float32)),
        "iq3xxs": _grid("iq3xxs", 4),
        "iq3s": _grid("iq3s", 4),
        "iq2xxs": _grid("iq2xxs", 8),
        "iq2xs": _grid("iq2xs", 8),
        "iq2s": _grid("iq2s", 8),
        "iq1s": _grid("iq1s", 8, np.int8),
        "sign128": _signs(raw()["ksigns"]),
        "sign256": _signs(np.arange(256)),
    }
    return {k: v.to(device) for k, v in t.items()}


def _words(a: np.ndarray, per_line: int = 8) -> str:
    w = a.view(np.uint32).reshape(-1)
    return ",\n".join("    " + ", ".join(f"0x{int(v):08x}u" for v in w[i : i + per_line])
                      for i in range(0, w.size, per_line))


def cuda_header() -> str:
    """The tables as CUDA C++ (see the module docstring)."""
    r = raw()
    x80 = (r["kvalues_iq4nl"].astype(np.int64) + 128).astype(np.uint8).view(np.uint32)
    parts = [
        "// Generated by llamacog_tpu_torch/quant/iq_tables.py from quant/iq_grids.npz; "
        "do not edit.",
        "#pragma once",
        "#include <stdint.h>",
        "// kvalues_iq4nl[q] + 128 as byte q of the 16 bytes of these four words",
        *(f"constexpr uint32_t IQ4NL_X80_{i} = 0x{int(v):08x}u;" for i, v in enumerate(x80)),
        "// grid entry e: levels 0..3 as the bytes of word e (the 8-level grids: words 2e,",
        "// 2e + 1); IQ1S_GRID: 1 + level j as the low nibble of byte j of word e, 1 + level",
        "// 4 + j as its high nibble",
    ]
    g1 = (r["iq1s"].view(np.int8).reshape(-1, 8) + 1).astype(np.uint32)
    iq1s = (g1[:, :4] | (g1[:, 4:] << 4)) << (8 * np.arange(4, dtype=np.uint32))
    grids = {name: r[name] for name in ("iq3xxs", "iq3s", "iq2s", "iq2xxs", "iq2xs")}
    grids["iq1s"] = np.bitwise_or.reduce(iq1s, axis=1).astype(np.uint32)
    for name, a in grids.items():
        parts.append(f"__device__ __align__(16) const uint32_t {name.upper()}_GRID"
                     f"[{a.view(np.uint32).size}] = {{\n"
                     f"{_words(a)}}};")
    return "\n".join(parts) + "\n"
