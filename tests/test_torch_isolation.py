"""Rules of the port: it imports neither JAX nor the JAX package, runs on the
GPU unless the caller asks for the CPU, and its raw kernel launchers take
CUDA tensors only."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import llamacog_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "llamacog_tpu" or m.startswith("llamacog_tpu."))
missing = sorted(set(REQUIRED) - set(names))
print(len(names), missing, bad, sep="|")
"""
# modules that must be among those imported (the walk finds every module;
# these are the ones whose absence would leave a rule untested)
_REQUIRED = ("llamacog_tpu_torch.runtime.engine", "llamacog_tpu_torch.runtime.sampler",
             "llamacog_tpu_torch.tools.cli", "llamacog_tpu_torch.quant.iq_tables")


def test_port_imports_no_jax_and_no_jax_package():
    """In a fresh interpreter (this test process has JAX loaded already),
    importing every module of the port pulls in no `jax` and no module
    named `llamacog_tpu` or `llamacog_tpu.*` — exact names, since the port's
    own name starts with the same string."""
    script = f"REQUIRED = {_REQUIRED!r}\n" + _IMPORT_ALL
    res = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    n, missing, bad = res.stdout.strip().split("|")
    assert int(n) >= 20
    assert missing == "[]"
    assert bad == "[]"


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(monkeypatch):
    from llamacog_tpu_torch import resolve_device
    from llamacog_tpu_torch.runtime.engine import Engine
    from llamacog_tpu_torch.utils.synthetic import llama3_8b_config, make_synthetic_params

    _no_cuda(monkeypatch)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    cfg = llama3_8b_config(n_layer=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine({"layers": []}, cfg, device=None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_synthetic_params(cfg)


def test_raw_kernel_launchers_refuse_cpu_tensors():
    from llamacog_tpu_torch.ops.cuda.flash_prefill import flash_prefill_kernel
    from llamacog_tpu_torch.ops.cuda.flash_q8 import (
        flash_decode_quant_kernel, flash_decode_stacked_dense, flash_prefill_quant_kernel)
    from llamacog_tpu_torch.runtime.kv_cache import QuantKVCache
    from llamacog_tpu_torch.ops.cuda.qmm import qgemm, qmv
    from llamacog_tpu_torch.utils.synthetic import random_wire

    w = random_wire("Q4_K", 16, 256, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="CUDA"):
        qmv(torch.zeros(1, 256), [w])
    with pytest.raises(ValueError, match="CUDA"):
        qgemm(torch.zeros(32, 256, dtype=torch.bfloat16), [w])
    q = torch.zeros(1, 4, 32)
    kv = torch.zeros(1, 1, 64, 2, 32)
    cur = torch.zeros(1, 2, 32)
    n = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        flash_decode_stacked_dense(q, kv, kv, 0, cur, cur, n, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        flash_prefill_kernel(torch.zeros(1, 8, 4, 32), kv[0], kv[0], torch.zeros(1, 8, 2, 32),
                             torch.zeros(1, 8, 2, 32), n, 1.0)
    planes = QuantKVCache.create(1, 1, 64, 2, 32, 32, kinds=("q8_0", "q4_1"))
    with pytest.raises(ValueError, match="CUDA"):
        flash_decode_quant_kernel(q, planes.k_planes, planes.v_planes, 0, cur, cur, n, 1.0,
                                  kinds=planes.kinds)
    with pytest.raises(ValueError, match="CUDA"):
        flash_prefill_quant_kernel(torch.zeros(1, 8, 4, 32), [p[0] for p in planes.k_planes],
                                   [p[0] for p in planes.v_planes], torch.zeros(1, 8, 2, 32),
                                   torch.zeros(1, 8, 2, 32), n, 1.0, kinds=planes.kinds)


def test_moe_entry_points_and_launchers_refuse_cpu(monkeypatch):
    """The MoE kernels (K10-K12) take CUDA tensors only, and the Mixtral
    synthetic model, like every entry point, needs CUDA unless asked for
    the CPU."""
    from llamacog_tpu_torch.ops.cuda.qmm_id import qgemm_id_kernel, qmv_id_kernel
    from llamacog_tpu_torch.utils.synthetic import (
        make_synthetic_params, mixtral_8x7b_config, random_experts)

    w = random_experts("Q4_K", 4, 64, 256, torch.Generator().manual_seed(0))
    ids = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        qmv_id_kernel(torch.zeros(2, 256), ids, w)
    with pytest.raises(ValueError, match="CUDA"):
        qgemm_id_kernel(torch.zeros(64, 256, dtype=torch.bfloat16), ids[:1], w, 64)
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_synthetic_params(mixtral_8x7b_config(n_layer=1))
