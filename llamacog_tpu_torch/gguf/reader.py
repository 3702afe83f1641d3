"""Memory-mapped GGUF reader.

Parses the GGUF v2/v3 container (layout documented at
llama.cpp's ggml/include/gguf.h:1-33) into typed metadata plus zero-copy
numpy views over the tensor data blob. Multi-file split models
(``split.count`` metadata, reference tools/gguf-split) are handled by
``GGUFModelReader``.
"""

from __future__ import annotations

import mmap
import os
import struct
from dataclasses import dataclass
from typing import Any, BinaryIO

import numpy as np

from .constants import (
    GGML_TYPE_TRAITS,
    GGUF_DEFAULT_ALIGNMENT,
    GGUF_KEY_GENERAL_ALIGNMENT,
    GGUF_MAGIC,
    GGMLType,
    GGUFValueType,
    row_nbytes,
)

_SCALAR_FMT: dict[GGUFValueType, str] = {
    GGUFValueType.UINT8: "<B",
    GGUFValueType.INT8: "<b",
    GGUFValueType.UINT16: "<H",
    GGUFValueType.INT16: "<h",
    GGUFValueType.UINT32: "<I",
    GGUFValueType.INT32: "<i",
    GGUFValueType.FLOAT32: "<f",
    GGUFValueType.BOOL: "<?",
    GGUFValueType.UINT64: "<Q",
    GGUFValueType.INT64: "<q",
    GGUFValueType.FLOAT64: "<d",
}

_SCALAR_NP: dict[GGUFValueType, np.dtype] = {
    GGUFValueType.UINT8: np.dtype("<u1"),
    GGUFValueType.INT8: np.dtype("<i1"),
    GGUFValueType.UINT16: np.dtype("<u2"),
    GGUFValueType.INT16: np.dtype("<i2"),
    GGUFValueType.UINT32: np.dtype("<u4"),
    GGUFValueType.INT32: np.dtype("<i4"),
    GGUFValueType.FLOAT32: np.dtype("<f4"),
    GGUFValueType.BOOL: np.dtype("<i1"),
    GGUFValueType.UINT64: np.dtype("<u8"),
    GGUFValueType.INT64: np.dtype("<i8"),
    GGUFValueType.FLOAT64: np.dtype("<f8"),
}


class GGUFFormatError(ValueError):
    pass


@dataclass
class TensorInfo:
    name: str
    #: numpy-order shape (row-major; last axis contiguous). GGUF stores ggml
    #: ne[] with ne[0] innermost; we reverse it.
    shape: tuple[int, ...]
    ggml_type: GGMLType
    offset: int  # relative to start of the data blob

    @property
    def n_elements(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    @property
    def nbytes(self) -> int:
        # rows are contiguous along the last axis
        inner = self.shape[-1] if self.shape else 1
        rows = self.n_elements // inner if inner else 0
        return rows * row_nbytes(self.ggml_type, inner)


class _Cursor:
    """Bounds-checked little-endian cursor over a bytes-like buffer."""

    def __init__(self, buf, offset: int = 0):
        self.buf = buf
        self.pos = offset
        self.end = len(buf)

    def take(self, n: int) -> memoryview:
        if n < 0 or self.pos + n > self.end:
            raise GGUFFormatError(
                f"truncated GGUF: need {n} bytes at offset {self.pos}, have {self.end - self.pos}"
            )
        mv = memoryview(self.buf)[self.pos : self.pos + n]
        self.pos += n
        return mv

    def scalar(self, vtype: GGUFValueType):
        fmt = _SCALAR_FMT[vtype]
        size = struct.calcsize(fmt)
        (val,) = struct.unpack(fmt, self.take(size))
        return val

    def u32(self) -> int:
        return self.scalar(GGUFValueType.UINT32)

    def u64(self) -> int:
        return self.scalar(GGUFValueType.UINT64)

    def i64(self) -> int:
        return self.scalar(GGUFValueType.INT64)

    def string(self) -> str:
        n = self.u64()
        if n > 2**31:
            raise GGUFFormatError(f"unreasonable string length {n}")
        return bytes(self.take(n)).decode("utf-8", errors="replace")

    def value(self, vtype: GGUFValueType):
        if vtype == GGUFValueType.STRING:
            return self.string()
        if vtype == GGUFValueType.ARRAY:
            item_type = GGUFValueType(self.u32())
            count = self.u64()
            if item_type == GGUFValueType.STRING:
                return [self.string() for _ in range(count)]
            if item_type == GGUFValueType.ARRAY:
                return [self.value(GGUFValueType.ARRAY) for _ in range(count)]
            dt = _SCALAR_NP[item_type]
            raw = self.take(count * dt.itemsize)
            # copy: metadata arrays are small and must outlive the mmap
            return np.frombuffer(raw, dtype=dt, count=count).copy()
        if vtype in _SCALAR_FMT:
            return self.scalar(vtype)
        raise GGUFFormatError(f"unknown GGUF value type {vtype}")


class GGUFReader:
    """Single-file GGUF reader. Tensor data stays mmapped (zero copy)."""

    def __init__(self, path: str | os.PathLike):
        self.path = os.fspath(path)
        self._file: BinaryIO = open(self.path, "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        self.metadata: dict[str, Any] = {}
        self.tensors: dict[str, TensorInfo] = {}
        self._parse()

    def _parse(self) -> None:
        cur = _Cursor(self._mm)
        magic = bytes(cur.take(4))
        if magic != GGUF_MAGIC:
            raise GGUFFormatError(f"bad magic {magic!r}")
        self.version = cur.u32()
        if self.version not in (2, 3):
            raise GGUFFormatError(f"unsupported GGUF version {self.version}")
        n_tensors = cur.i64()
        n_kv = cur.i64()
        if n_tensors < 0 or n_kv < 0 or n_tensors > 10**8 or n_kv > 10**8:
            raise GGUFFormatError(f"implausible counts n_tensors={n_tensors} n_kv={n_kv}")

        for _ in range(n_kv):
            key = cur.string()
            vtype = GGUFValueType(cur.u32())
            self.metadata[key] = cur.value(vtype)

        infos: list[TensorInfo] = []
        for _ in range(n_tensors):
            name = cur.string()
            n_dims = cur.u32()
            if n_dims > 4:
                raise GGUFFormatError(f"tensor {name!r}: n_dims={n_dims} > 4")
            ne = [cur.i64() for _ in range(n_dims)]
            ttype = GGMLType(cur.u32())
            offset = cur.u64()
            if ttype not in GGML_TYPE_TRAITS:
                raise GGUFFormatError(f"tensor {name!r}: unsupported type {ttype}")
            infos.append(TensorInfo(name, tuple(reversed(ne)) or (1,), ttype, offset))

        self.alignment = int(self.metadata.get(GGUF_KEY_GENERAL_ALIGNMENT, GGUF_DEFAULT_ALIGNMENT))
        if self.alignment <= 0 or self.alignment & (self.alignment - 1):
            raise GGUFFormatError(f"bad alignment {self.alignment}")
        self.data_offset = (cur.pos + self.alignment - 1) // self.alignment * self.alignment

        blob_size = len(self._mm) - self.data_offset
        for ti in infos:
            if ti.offset % self.alignment:
                raise GGUFFormatError(f"tensor {ti.name!r}: misaligned offset {ti.offset}")
            if ti.offset + ti.nbytes > blob_size:
                raise GGUFFormatError(
                    f"tensor {ti.name!r}: data [{ti.offset}, {ti.offset + ti.nbytes}) "
                    f"out of bounds (blob {blob_size})"
                )
            if ti.name in self.tensors:
                raise GGUFFormatError(f"duplicate tensor {ti.name!r}")
            self.tensors[ti.name] = ti

    def tensor_bytes(self, name: str) -> np.ndarray:
        """Raw bytes of a tensor as a uint8 view (no copy)."""
        ti = self.tensors[name]
        start = self.data_offset + ti.offset
        return np.frombuffer(self._mm, dtype=np.uint8, count=ti.nbytes, offset=start)

    def close(self) -> None:
        try:
            self._mm.close()
        except BufferError:
            # zero-copy tensor views still alive; the mapping is released when
            # they are garbage-collected
            pass
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class GGUFModelReader:
    """A logical model over one GGUF file or a `-00001-of-0000N` split set."""

    def __init__(self, path: str | os.PathLike):
        path = os.fspath(path)
        self.readers = [GGUFReader(path)]
        meta = self.readers[0].metadata
        n_split = int(meta.get("split.count", 0) or 0)
        if n_split > 1:
            import re

            m = re.match(r"^(.*)-(\d{5})-of-(\d{5})\.gguf$", path)
            if not m:
                raise GGUFFormatError(f"split model but unrecognized filename {path!r}")
            base, _, total = m.groups()
            if int(total) != n_split:
                raise GGUFFormatError("split.count mismatch with filename")
            for i in range(2, n_split + 1):
                self.readers.append(GGUFReader(f"{base}-{i:05d}-of-{n_split:05d}.gguf"))
        self.metadata: dict[str, Any] = {}
        self.tensors: dict[str, tuple[GGUFReader, TensorInfo]] = {}
        for r in self.readers:
            self.metadata.update(r.metadata)
            for name, ti in r.tensors.items():
                self.tensors[name] = (r, ti)

    def tensor_info(self, name: str) -> TensorInfo:
        return self.tensors[name][1]

    def tensor_bytes(self, name: str) -> np.ndarray:
        r, _ = self.tensors[name]
        return r.tensor_bytes(name)

    def names(self) -> list[str]:
        return list(self.tensors)

    def close(self) -> None:
        for r in self.readers:
            r.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
