"""Carry a model's weights across into the port's parameter tree.

``from_reference`` takes the model's tensors by GGUF name, in their file
form — dense tensors as float numpy arrays, quantized tensors as
``(ggml_type, shape, uint8 block bytes)`` — and returns the port's params
with the same keys as the JAX loader's tree (``attn_qk``, ``attn_v``,
``ffn_gate_up``, ``ffn_gate_up_exps``, ...), applying the same fusion
under the same conditions (llamacog_tpu/models/loader.py:297-350) and the
same per-arch renames (chameleon's swin norms, dbrx's and grok's norms,
loader.py:349-368): q/k/v of one kind fuse, their biases concatenated;
else q+k fuse, unless q carries a bias or a norm; neither under a q/k norm
over the whole projection (olmo2, olmoe) or where q carries a scale
(bitnet); gate+up fuse unless gate carries a bias or a scale; a lone
ffn_up of 2 x n_ff rows (phi3's, glm4's and chatglm's pre-fused [gate;
up]) becomes ffn_gate_up. Layers whose tensors differ in shape (openelm's
per-layer heads and FFN widths, deci's attention-free and FFN-free
layers) load as they stand.
Quantized tensors stay in wire format; fusing two of them is a row
concatenation of their block bytes. The port's loader and
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
    "attn_norm_b": "attn_norm.bias",
    "attn_norm_2": "attn_norm_2.weight",  # falcon-40B: the attention's own norm
    "attn_norm_2_b": "attn_norm_2.bias",
    "attn_qkv": "attn_qkv.weight",
    "attn_qkv_b": "attn_qkv.bias",
    "attn_q": "attn_q.weight",
    "attn_k": "attn_k.weight",
    "attn_v": "attn_v.weight",
    "attn_q_b": "attn_q.bias",
    "attn_k_b": "attn_k.bias",
    "attn_v_b": "attn_v.bias",
    "attn_q_norm": "attn_q_norm.weight",
    "attn_k_norm": "attn_k_norm.weight",
    "attn_q_norm_b": "attn_q_norm.bias",  # chameleon's per-head layer norms
    "attn_k_norm_b": "attn_k_norm.bias",
    # deepseek2's MLA; the q LoRA's second product is attn_q_b_proj, apart
    # from the q bias key attn_q_b (the JAX loader's names, loader.py:45-53)
    "attn_q_a": "attn_q_a.weight",
    "attn_q_a_norm": "attn_q_a_norm.weight",
    "attn_q_b_proj": "attn_q_b.weight",
    "attn_kv_a_mqa": "attn_kv_a_mqa.weight",
    "attn_kv_a_norm": "attn_kv_a_norm.weight",
    "attn_kv_b": "attn_kv_b.weight",
    "attn_output": "attn_output.weight",
    "attn_output_b": "attn_output.bias",
    "attn_post_norm": "post_attention_norm.weight",
    # the BERT-style names under which dbrx keeps its pre-FFN norm and grok
    # its post-norms (renamed below, as the JAX loader renames them)
    "attn_out_norm": "attn_output_norm.weight",
    "attn_out_norm_b": "attn_output_norm.bias",
    "layer_out_norm": "layer_output_norm.weight",
    "layer_out_norm_b": "layer_output_norm.bias",
    "ffn_norm": "ffn_norm.weight",
    "ffn_norm_b": "ffn_norm.bias",
    "ffn_post_norm": "post_ffw_norm.weight",
    # arctic's norm of its MoE branch; the name does not end in
    # "_norm.weight", so it takes the model dtype, as in the JAX loader
    "ffn_norm_exps": "ffn_norm_exps.weight",
    "ffn_gate": "ffn_gate.weight",
    "ffn_up": "ffn_up.weight",
    "ffn_down": "ffn_down.weight",
    "ffn_gate_b": "ffn_gate.bias",
    "ffn_up_b": "ffn_up.bias",
    "ffn_down_b": "ffn_down.bias",
    "ffn_gate_inp": "ffn_gate_inp.weight",
    "ffn_gate_exps": "ffn_gate_exps.weight",
    "ffn_up_exps": "ffn_up_exps.weight",
    "ffn_down_exps": "ffn_down_exps.weight",
    "ffn_gate_inp_shexp": "ffn_gate_inp_shexp.weight",
    "ffn_gate_shexp": "ffn_gate_shexp.weight",
    "ffn_up_shexp": "ffn_up_shexp.weight",
    "ffn_down_shexp": "ffn_down_shexp.weight",
    "exp_probs_b": "exp_probs_b.bias",  # DeepSeek-V3's selection bias
    # bitnet: rms sub-norms before attn_output and ffn_down, and each
    # product's scalar scale (model dtype: the names end in neither
    # "_norm.weight" nor ".bias", as in the JAX loader)
    "attn_sub_norm": "attn_sub_norm.weight",
    "ffn_sub_norm": "ffn_sub_norm.weight",
    **{f"{t}_scale": f"{t}.scale" for t in ("attn_q", "attn_k", "attn_v", "attn_output",
                                            "ffn_gate", "ffn_up", "ffn_down")},
}
_MODEL_TENSORS = {
    "tok_embd": "token_embd.weight",
    "output_norm": "output_norm.weight",
    "output": "output.weight",
    "output_b": "output.bias",
    "output_norm_b": "output_norm.bias",
    # learned positions (gpt2, starcoder): dense in the model dtype, or
    # quantized, taken as a wire tensor whose looked-up rows are decoded
    "pos_embd": "position_embd.weight",
    # bloom's layer norm of the embedding (f32, as every norm)
    "tok_norm": "token_embd_norm.weight",
    "tok_norm_b": "token_embd_norm.bias",
    "rope_freqs": "rope_freqs.weight",
    "rope_long": "rope_factors_long.weight",  # phi3 longrope
    "rope_short": "rope_factors_short.weight",
}
# the absorbed MLA of newer llama.cpp DeepSeek conversions, which the JAX
# loader has no keys for
_ABSORBED_MLA = ("attn_k_b.weight", "attn_v_b.weight")
# tensors the JAX loader always keeps dense and f32 (norms, biases)
_F32_SUFFIXES = ("_norm.weight", ".bias")


def _to_param(name: str, value, device, dtype):
    if isinstance(value, tuple):
        if name.endswith(_F32_SUFFIXES):
            raise NotImplementedError(f"{name}: quantized norm and bias tensors are not "
                                      "ported yet")
        ggml_type, shape, data = value
        return wire.from_bytes(data, ggml_type, tuple(shape), device)
    arr = np.asarray(value, dtype=np.float32)
    dt = torch.float32 if name.endswith(_F32_SUFFIXES) else dtype
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device=device, dtype=dt)


def from_reference(cfg: ModelConfig, tensors: dict, device=None,
                   dtype=torch.bfloat16) -> dict:
    """GGUF-named tensors -> the port's params on `device` (None = CUDA)."""
    check_supported(cfg)
    dev = resolve_device(device)
    if any(n.endswith(_ABSORBED_MLA) for n in tensors):
        raise NotImplementedError("absorbed MLA (attn_k_b.weight / attn_v_b.weight, a newer "
                                  "llama.cpp DeepSeek conversion) is not ported yet")
    # q/k norm biases belong to chameleon's per-head layer norms; MPT's
    # whole-projection layer norms carry them too, which the JAX forward
    # cannot broadcast over the heads, so another arch's stay refused
    layer_names = set(_LAYER_TENSORS.values())
    if not cfg.qk_norm_layer:
        layer_names -= {"attn_q_norm.bias", "attn_k_norm.bias"}
    unknown = sorted(n for n in tensors if n not in _MODEL_TENSORS.values()
                     and not (n.startswith("blk.") and n.split(".", 2)[2] in layer_names))
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
        # olmo2, olmoe: a q/k norm over the whole projection needs q and k
        # apart, and so do bitnet's scaled products (the JAX loader's rules,
        # loader.py:297-302)
        apart = (cfg.qk_norm_full and "attn_q_norm" in layer) or "attn_q_scale" in layer
        if all(k in layer for k in ("attn_q", "attn_k", "attn_v")) and not apart:
            fused = wire.fuse_rows([layer["attn_q"], layer["attn_k"], layer["attn_v"]])
            if fused is not None:
                layer["attn_qkv"] = fused
                del layer["attn_q"], layer["attn_k"], layer["attn_v"]
                if all(f"attn_{t}_b" in layer for t in "qkv"):
                    layer["attn_qkv_b"] = torch.cat([layer.pop(f"attn_{t}_b") for t in "qkv"])
            elif "attn_q_b" not in layer and "attn_q_norm" not in layer:
                # mixed kinds (Q4_K_M stores attn_v as Q6_K): fuse q+k, which
                # a bias or a per-head norm of q must see apart
                qk = wire.fuse_rows([layer["attn_q"], layer["attn_k"]])
                if qk is not None:
                    layer["attn_qk"] = qk
                    del layer["attn_q"], layer["attn_k"]
        if ("ffn_gate" in layer and "ffn_up" in layer and "ffn_gate_b" not in layer
                and "ffn_gate_scale" not in layer):
            fused = wire.fuse_rows([layer["ffn_gate"], layer["ffn_up"]])
            if fused is not None:
                layer["ffn_gate_up"] = fused
                del layer["ffn_gate"], layer["ffn_up"]
        if "ffn_gate" not in layer and "ffn_up" in layer \
                and layer["ffn_up"].shape[0] == 2 * cfg.n_ff:
            layer["ffn_gate_up"] = layer.pop("ffn_up")  # phi3: [gate; up] in one tensor
        if "ffn_gate_exps" in layer and "ffn_up_exps" in layer:
            fused = wire.fuse_experts(layer["ffn_gate_exps"], layer["ffn_up_exps"])
            if fused is not None:
                layer["ffn_gate_up_exps"] = fused
                del layer["ffn_gate_exps"], layer["ffn_up_exps"]
        # the JAX loader's per-arch renames (loader.py:349-368): chameleon's
        # swin ordering applies attn_norm and ffn_norm to the branch outputs;
        # dbrx's attn_output_norm is its pre-FFN norm; grok's two BERT-style
        # norms are its post-attention and post-FFN norms
        if cfg.arch == "chameleon" and cfg.post_norm_only:
            for old, new in (("attn_norm", "attn_post_norm"), ("ffn_norm", "ffn_post_norm")):
                if old in layer:
                    layer[new] = layer.pop(old)
        if cfg.arch == "dbrx" and "attn_out_norm" in layer:
            layer["ffn_norm"] = layer.pop("attn_out_norm")
        if cfg.arch == "grok":
            for old, new in (("attn_out_norm", "attn_post_norm"),
                             ("layer_out_norm", "ffn_post_norm")):
                if old in layer:
                    layer[new] = layer.pop(old)
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
