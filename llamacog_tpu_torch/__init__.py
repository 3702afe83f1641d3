"""llamacog_tpu_torch — the PyTorch + CUDA port of llamacog_tpu.

Runs single-stream greedy generation of llama-family Q4_K_M models, dense
or sparse MoE (Mixtral), on an NVIDIA Hopper GPU. Weights stay in GGUF
wire format on the device; the fused dequant x matmul, the attention and
the MoE expert products are hand-written CUDA C++ (``csrc/``), each with a
plain PyTorch version beside it. The JAX
package ``llamacog_tpu`` is the reference this port is tested against; the
port imports nothing from it.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on. ``None`` means CUDA; the CPU is
    used only when the caller asks for it. Raises when CUDA is wanted but
    absent — nothing silently runs on the CPU instead."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available "
            "(pass device='cpu' to run the plain PyTorch path)")
    return dev
