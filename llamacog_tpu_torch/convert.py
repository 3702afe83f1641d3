"""Carry a llama model's weights across into the port's parameter tree.

``from_reference`` takes the model's tensors by GGUF name, in their file
form — dense tensors as float numpy arrays, quantized tensors as
``(ggml_type, shape, uint8 block bytes)`` — and returns the port's params
with the same keys as the JAX loader's tree (``attn_qk``, ``attn_v``,
``ffn_gate_up``, ``ffn_gate_up_exps``, ...), applying the same fusion
(llamacog_tpu/models/loader.py:297-348). Quantized tensors stay in wire
format; fusing two of them is a row concatenation of their block bytes. The port's loader and
the tests that hold the port against the JAX package both go through it:
the JAX package's planar planes cannot be turned back into wire bytes, so
weights cross over in their file form.
"""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .gguf import GGMLType
from .models.config import ModelConfig
from .models.llama import check_supported
from .quant import wire
from .runtime.kv_cache import KVCache, quant_cache_class

_LAYER_TENSORS = {
    "attn_norm": "attn_norm.weight",
    "attn_q": "attn_q.weight",
    "attn_k": "attn_k.weight",
    "attn_v": "attn_v.weight",
    "attn_output": "attn_output.weight",
    "ffn_norm": "ffn_norm.weight",
    "ffn_gate": "ffn_gate.weight",
    "ffn_up": "ffn_up.weight",
    "ffn_down": "ffn_down.weight",
    "ffn_gate_inp": "ffn_gate_inp.weight",
    "ffn_gate_exps": "ffn_gate_exps.weight",
    "ffn_up_exps": "ffn_up_exps.weight",
    "ffn_down_exps": "ffn_down_exps.weight",
}
_MODEL_TENSORS = {
    "tok_embd": "token_embd.weight",
    "output_norm": "output_norm.weight",
    "output": "output.weight",
    "rope_freqs": "rope_freqs.weight",
}
# tensors the JAX loader always keeps dense and f32
_F32_SUFFIX = "_norm.weight"


def _to_param(name: str, value, device, dtype):
    if isinstance(value, tuple):
        if name.endswith(_F32_SUFFIX):
            raise NotImplementedError(f"{name}: quantized norm tensors are not ported yet")
        ggml_type, shape, data = value
        return wire.from_bytes(data, ggml_type, tuple(shape), device)
    arr = np.asarray(value, dtype=np.float32)
    dt = torch.float32 if name.endswith(_F32_SUFFIX) else dtype
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device=device, dtype=dt)


def from_reference(cfg: ModelConfig, tensors: dict, device=None,
                   dtype=torch.bfloat16) -> dict:
    """GGUF-named tensors -> the port's params on `device` (None = CUDA)."""
    check_supported(cfg)
    dev = resolve_device(device)
    unknown = sorted(n for n in tensors if n not in _MODEL_TENSORS.values()
                     and not (n.startswith("blk.")
                              and n.split(".", 2)[2] in _LAYER_TENSORS.values()))
    if unknown:
        raise NotImplementedError(f"tensors not ported yet: {unknown[:8]}")
    params: dict = {"layers": []}
    for key, name in _MODEL_TENSORS.items():
        if name in tensors:
            params[key] = _to_param(name, tensors[name], dev, dtype)
    for il in range(cfg.n_layer):
        layer = {}
        for key, suffix in _LAYER_TENSORS.items():
            name = f"blk.{il}.{suffix}"
            if name in tensors:
                layer[key] = _to_param(name, tensors[name], dev, dtype)
        if all(k in layer for k in ("attn_q", "attn_k", "attn_v")):
            fused = wire.fuse_rows([layer["attn_q"], layer["attn_k"], layer["attn_v"]])
            if fused is not None:
                layer["attn_qkv"] = fused
                del layer["attn_q"], layer["attn_k"], layer["attn_v"]
            else:
                # mixed kinds (Q4_K_M stores attn_v as Q6_K): fuse q+k
                qk = wire.fuse_rows([layer["attn_q"], layer["attn_k"]])
                if qk is not None:
                    layer["attn_qk"] = qk
                    del layer["attn_q"], layer["attn_k"]
        if "ffn_gate" in layer and "ffn_up" in layer:
            fused = wire.fuse_rows([layer["ffn_gate"], layer["ffn_up"]])
            if fused is not None:
                layer["ffn_gate_up"] = fused
                del layer["ffn_gate"], layer["ffn_up"]
        if "ffn_gate_exps" in layer and "ffn_up_exps" in layer:
            fused = wire.fuse_experts(layer["ffn_gate_exps"], layer["ffn_up_exps"])
            if fused is not None:
                layer["ffn_gate_up_exps"] = fused
                del layer["ffn_gate_exps"], layer["ffn_up_exps"]
        params["layers"].append(layer)
    return params


def gguf_tensors(reader) -> dict:
    """All tensors of an open GGUF reader in from_reference's input form."""
    out = {}
    for name, (r, ti) in reader.tensors.items():
        data = r.tensor_bytes(name)
        shape = tuple(int(s) for s in ti.shape)
        if GGMLType(ti.ggml_type) in wire.DENSE_TYPES:
            out[name] = wire.dense_from_bytes(data, ti.ggml_type, shape)
        else:
            out[name] = (GGMLType(ti.ggml_type), shape, np.asarray(data, np.uint8))
    return out


def _cache_tensor(arr, dev) -> torch.Tensor:
    """A numpy array of a reference cache -> a tensor on `dev`. bfloat16
    arrives as numpy's extension type, which torch.from_numpy does not
    take: its bits cross as uint16. The array is copied (a JAX array's
    numpy view is read-only)."""
    arr = np.array(arr, order="C")
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(arr).to(dev)


def kv_cache_from_reference(k_planes, v_planes, kinds, hkv, device=None):
    """The numpy planes of a JAX KVCache (kinds None: one [L, B, S, Hkv, D]
    array per tensor) or QuantKVCache (its k_planes/v_planes, kinds, hkv) ->
    the port's cache on `device` (None = CUDA), the same layout plane for
    plane, so both packages can compute from the same state."""
    dev = resolve_device(device)
    k = tuple(_cache_tensor(p, dev) for p in k_planes)
    v = tuple(_cache_tensor(p, dev) for p in v_planes)
    if kinds is None:
        return KVCache(k[0], v[0])
    return quant_cache_class(kinds)(k, v, kinds, hkv)
