"""Build and bind the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles on its own, with ``nvcc`` for ``sm_90a``,
into a shared library with a plain C interface, loaded with ``ctypes``. The
libraries go to ``csrc/build/`` (listed in ``.gitignore``) under a name
that hashes the sources and flags, so an edited source is rebuilt and an
unchanged one is reused. Nothing here runs at import: a library is built
the first time its kernel is launched, or all at once by :func:`build`,
which starts one ``nvcc`` per source in parallel.

Every launcher returns ``cudaGetLastError()``; :func:`check` raises on a
non-zero code. ``LAUNCHES`` counts the launches of each kernel: a wrapper
adds one where it launches, and nowhere else. ``flash_decode`` (K9) has a
count of its own but no source: it launches the flash_decode_dense library
on one layer's tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = CSRC / "build"
KERNELS = ("qmv", "qgemm", "flash_decode_dense", "flash_prefill", "flash_decode_quant",
           "flash_prefill_quant", "qmv_id", "qgemm_id", "qmm_i8")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# element types the launchers take, as csrc/common.cuh numbers them
DTYPE_ID = {torch.float32: 0, torch.bfloat16: 1}
# KV cache plane kinds, as csrc/common.cuh numbers them (KV_Q8_0 ...)
KV_KIND_ID = {"q8_0": 0, "q4_0": 1, "q4_1": 2, "q5_0": 3, "q5_1": 4, "f16": 5, "bf16": 6}

LAUNCHES = {name: 0 for name in (*KERNELS, "flash_decode")}
BUILD_LOG: dict[str, str] = {}  # nvcc/ptxas output (registers, smem, spills)
_LIBS: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in (*sorted(CSRC.glob("*.cuh")), CSRC / f"{name}.cu"):
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=KERNELS) -> dict[str, float]:
    """Compile the named kernels that are not built yet, one nvcc process
    per source, all started together. Returns the seconds each took;
    raises with the compiler's output when one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, out, time.perf_counter())
    secs, failed = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return secs


def _bind(lib: ctypes.CDLL) -> None:
    vp, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    ptrs, ints = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)
    sigs = {
        "lcg_qmv": [vp, i, i, i, i, ptrs, ptrs, ints, ints, vp],
        "lcg_qgemm": [vp, i, i, i, i, ptrs, ptrs, ints, ints, vp],
        "lcg_flash_decode_dense": [i, vp, vp, vp, i, i, i, i, i, i, i, vp, vp, vp, vp,
                                   i, f, f, i, vp],
        "lcg_flash_prefill": [i, vp, vp, vp, ll, ll, ll, ll, vp, vp, vp, vp,
                              i, i, i, i, i, i, i, f, f, i, vp],
        "lcg_flash_decode_quant": [i, i, i, vp, *[vp] * 8, i, i, i, i, i, i, vp, vp, vp, vp,
                                   i, f, f, i, vp],
        "lcg_flash_prefill_quant": [i, i, i, vp, *[vp] * 8, i, i, i, i, i, i, i, vp, vp, vp, vp,
                                    i, f, f, i, vp],
        "lcg_qmv_id": [vp, i, i, i, vp, i, i, i, vp, vp, vp],
        "lcg_qgemm_id": [vp, i, i, i, vp, i, i, i, vp, i, vp, vp],
        "lcg_qmm_i8": [vp, vp, vp, vp, vp, i, i, i, vp],
    }
    for fn, argtypes in sigs.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    lib.lcg_error_string.argtypes = [ctypes.c_int]
    lib.lcg_error_string.restype = ctypes.c_char_p


def load(name: str) -> ctypes.CDLL:
    """The bound library of kernel `name`, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(_lib_path(name)))
        _bind(lib)
        _LIBS[name] = lib
    return lib


def on_device(x: torch.Tensor, kernel, plain, *args, **kwargs):
    """`kernel` for a CUDA tensor x, `plain` (the kernel's plain PyTorch
    version) for a CPU tensor; other devices raise."""
    if x.is_cuda:
        return kernel(x, *args, **kwargs)
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return plain(x, *args, **kwargs)


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.lcg_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc} ({msg})")
