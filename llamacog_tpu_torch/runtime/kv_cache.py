"""Static-shape dense KV cache.

Counterpart of llamacog_tpu/runtime/kv_cache.py::KVCache: a preallocated
stacked [L, B, S_max, Hkv, D] pair. The JAX version returns a new cache
from every write; this one is updated in place (the deferred bulk write of
a step lands with one index_copy_ per plane and row), which saves the
cache-sized copies a functional update would cost.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class KVCache:
    k: torch.Tensor  # [L, B, S, Hkv, Dk]
    v: torch.Tensor  # [L, B, S, Hkv, Dv]

    @property
    def max_seq(self) -> int:
        return self.k.shape[2]

    @classmethod
    def create(cls, n_layers, batch, max_seq, n_head_kv, head_dim_k, head_dim_v,
               dtype=torch.bfloat16, device=None) -> "KVCache":
        return cls(
            k=torch.zeros((n_layers, batch, max_seq, n_head_kv, head_dim_k), dtype=dtype,
                          device=device),
            v=torch.zeros((n_layers, batch, max_seq, n_head_kv, head_dim_v), dtype=dtype,
                          device=device),
        )

    def read(self, layer: int):
        """(k, v) [B, S, Hkv, D] views of one layer (old contents only)."""
        return self.k[layer], self.v[layer]

    def write_all(self, k_new: torch.Tensor, v_new: torch.Tensor,
                  write_pos: torch.Tensor) -> "KVCache":
        """Deferred bulk write of a step, in place: [L, B, T, Hkv, D] for all
        layers at per-row offsets write_pos [B] (a device tensor, so the
        decode loop needs no host sync). The caller keeps
        write_pos + T <= max_seq."""
        T = k_new.shape[2]
        steps = torch.arange(T, device=write_pos.device)
        for b in range(k_new.shape[1]):
            idx = write_pos[b].long() + steps
            self.k[:, b].index_copy_(1, idx, k_new[:, b].to(self.k.dtype))
            self.v[:, b].index_copy_(1, idx, v_new[:, b].to(self.v.dtype))
        return self
