"""Synthetic random-weight models built directly in GGUF wire format.

Counterpart of llamacog_tpu/utils/synthetic.py. Benchmarking Llama-3-8B
Q4_K_M needs 8B-scale weights and no real checkpoint ships with the repo;
decode cost depends on the block bytes only, so the parameters are random
wire blocks made on the device from a torch.Generator. The per-tensor kind
policy is the JAX package's (after llama_tensor_get_type for Q4_K_M):
attn_v and output are Q6_K, ffn_down is Q6_K on the "use more bits" layers,
everything else Q4_K; q+k and gate+up arrive fused, as the loader fuses a
real Q4_K_M file.
"""

from __future__ import annotations

import torch

from ..models.config import ModelConfig, RopeConfig
from ..quant.wire import BLOCK_BYTES, QK_K, WireTensor

# byte offsets of each kind's f16 superblock scales (d, and dmin for Q4_K)
_F16_FIELDS = {"Q4_K": (0, 2), "Q6_K": (208,)}


def random_wire(kind: str, n: int, k: int, generator: torch.Generator,
                device=None) -> WireTensor:
    """Random [n, k] wire blocks: random bytes for the codes and sub-scales,
    and finite small positive f16 superblock scales in [1e-4, 1e-3] (random
    bits there would give NaN and Inf)."""
    bpb = BLOCK_BYTES[kind]
    nb = k // QK_K
    blocks = torch.randint(0, 256, (n, nb, bpb), dtype=torch.uint8,
                           generator=generator, device=device)
    for off in _F16_FIELDS[kind]:
        d = torch.rand((n, nb, 1), generator=generator, device=device) * 9e-4 + 1e-4
        blocks[:, :, off : off + 2] = d.to(torch.float16).view(torch.uint8)
    return WireTensor(kind, (n, k), blocks.reshape(n, nb * bpb))


def _use_more_bits(i: int, n: int) -> bool:
    return i < n // 8 or i >= 7 * n // 8 or (i - n // 8) % 3 == 2


def llama3_8b_config(n_layer: int = 32) -> ModelConfig:
    """Llama-3-8B geometry; `n_layer` cuts depth only."""
    return ModelConfig(
        arch="llama", n_vocab=128256, n_ctx_train=8192, n_embd=4096,
        n_layer=n_layer, n_head=32, n_head_kv=8, n_ff=14336,
        head_dim_k=128, head_dim_v=128,
        rope=RopeConfig(dim=128, freq_base=500000.0),
    )


def make_synthetic_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Random Q4_K_M params for the llama forward, on `device`."""
    from .. import resolve_device

    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    E, F = cfg.n_embd, cfg.n_ff
    kv = cfg.n_head_kv * cfg.head_dim_k
    params: dict = {
        "tok_embd": random_wire("Q4_K", cfg.n_vocab, E, g, dev),
        "output": random_wire("Q6_K", cfg.n_vocab, E, g, dev),
        "output_norm": torch.ones(E, dtype=torch.float32, device=dev),
        "layers": [],
    }
    for il in range(cfg.n_layer):
        down_kind = "Q6_K" if _use_more_bits(il, cfg.n_layer) else "Q4_K"
        params["layers"].append({
            "attn_norm": torch.ones(E, dtype=torch.float32, device=dev),
            "ffn_norm": torch.ones(E, dtype=torch.float32, device=dev),
            "attn_qk": random_wire("Q4_K", cfg.n_head * cfg.head_dim_k + kv, E, g, dev),
            "attn_v": random_wire("Q6_K", kv, E, g, dev),
            "attn_output": random_wire("Q4_K", E, cfg.n_head * cfg.head_dim_v, g, dev),
            "ffn_gate_up": random_wire("Q4_K", 2 * F, E, g, dev),
            "ffn_down": random_wire(down_kind, E, F, g, dev),
        })
    return params
