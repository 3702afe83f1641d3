"""Single-stream generation engine (PyTorch).

Counterpart of llamacog_tpu/runtime/engine.py::Engine for the llama path,
with the dense cache or the quantized one (kv_type, the -ctk/-ctv kinds,
through make_cache): prefill in padded length buckets (the pad slots are
written to the cache, as the JAX engine writes them), one-token decode
steps, and a greedy loop that keeps the token on the device. The cache bound `_kv_cap`
is the JAX engine's. With ``LLAMACOG_MMQ=1`` (read at construction, as
engine.py:59 reads it) the engine attaches int8 prefill planes to its own
copy of the params (quant/mmq.py), so prefill chunks of MMQ_MIN_B rows or
more take the int8 GEMM. Steps run eagerly; capturing the decode step in a
CUDA graph is later work.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import resolve_device
from ..models.config import ModelConfig
from ..models.llama import check_supported, forward
from ..quant.mmq import attach_mmq_planes
from .kv_cache import make_cache

PREFILL_BUCKETS = (32, 128, 512, 2048)
# longest single prefill step; longer prompts loop chunks of this size
PREFILL_MAX_CHUNK = 2048


def _bucket(n: int) -> int:
    for b in PREFILL_BUCKETS:
        if n <= b:
            return b
    return -(-n // 2048) * 2048


def _param_devices(params: dict) -> set:
    tensors = [v for k, v in params.items() if k != "layers"]
    tensors += [v for layer in params["layers"] for v in layer.values()]
    return {t.device for t in tensors}


class Engine:
    """Owns the KV cache and the step functions of one model."""

    def __init__(self, params: dict, config: ModelConfig, batch_size: int = 1,
                 max_seq: int = 2048, dtype=torch.bfloat16, kv_type: str = "dense",
                 device=None):
        check_supported(config)
        if batch_size != 1:
            raise NotImplementedError("batch_size > 1 is not ported yet")
        self.device = resolve_device(device)
        stray = {str(d) for d in _param_devices(params) if d.type != self.device.type}
        if stray:
            raise ValueError(f"params live on {sorted(stray)}, the engine on {self.device}")
        if os.environ.get("LLAMACOG_MMQ", "0") == "1":
            params = attach_mmq_planes(params)  # a new dict; the caller's is untouched
        self.params = params
        self.config = config
        self.batch_size = batch_size
        self.max_seq = max_seq
        self.dtype = dtype
        self.cache = make_cache(kv_type, config.n_layer, batch_size, max_seq, config.n_head_kv,
                                config.head_dim_k, config.head_dim_v, dtype=dtype,
                                device=self.device)
        self.seq_len = np.zeros(batch_size, dtype=np.int32)  # host-side lengths

    def _dev_i32(self, values) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values, np.int32), device=self.device)

    def _step(self, tokens: torch.Tensor, write_pos: torch.Tensor, t: int,
              last_pos=None, kv_cap=None) -> torch.Tensor:
        positions = write_pos[:, None].long() + torch.arange(t, device=self.device)[None, :]
        logits, self.cache = forward(
            self.params, self.config, tokens, positions, self.cache, write_pos,
            dtype=self.dtype, logits_last=last_pos, kv_cap=kv_cap)
        return logits

    def _kv_cap(self, needed: int) -> int | None:
        """Attended-cache bound bucketed to 2048 (the reference's padded
        n_kv): decode at depth 1k in a 16k cache must not read 16k of K/V."""
        cap = max(2048, -(-int(needed) // 2048) * 2048)
        return min(cap, self.max_seq)

    def reset(self):
        self.seq_len[:] = 0

    def _prefill_t(self, n: int) -> int:
        if n > self.max_seq:
            raise ValueError(f"prompt of {n} tokens exceeds max_seq {self.max_seq}")
        return min(_bucket(n), self.max_seq)

    def _prefill_t_at(self, n: int, wp: int) -> int:
        """Padded length that fits the row's tail of the cache."""
        t = self._prefill_t(n)
        if wp + t > self.max_seq:
            if wp + n > self.max_seq:
                raise ValueError(f"context full: {wp}+{n} tokens > max_seq {self.max_seq}")
            t = self.max_seq - wp  # exact tail fit, no padding
        return t

    def _prefill_chunk(self, token_ids) -> torch.Tensor:
        n = len(token_ids)
        t = self._prefill_t_at(n, int(self.seq_len[0]))
        toks = np.zeros((self.batch_size, t), dtype=np.int64)
        toks[0, :n] = token_ids
        logits = self._step(torch.as_tensor(toks, device=self.device),
                            self._dev_i32(self.seq_len), t, last_pos=[n - 1],
                            kv_cap=self._kv_cap(int(self.seq_len.max()) + t))
        self.seq_len = self.seq_len + n
        return logits[0, -1]

    def prefill(self, token_ids: list[int]) -> np.ndarray:
        """Feed a prompt; returns the f32 logits [V] of its last token.
        Prompts longer than PREFILL_MAX_CHUNK run as a chunk loop."""
        if not len(token_ids):
            raise ValueError("empty prompt: nothing to prefill")
        for off in range(0, len(token_ids), PREFILL_MAX_CHUNK):
            logits = self._prefill_chunk(token_ids[off : off + PREFILL_MAX_CHUNK])
        return logits.cpu().numpy()

    def decode_one(self, token_ids) -> np.ndarray:
        """One decode step for all rows: token_ids [B] -> logits [B, V]."""
        if int(self.seq_len.max()) + 1 > self.max_seq:
            raise ValueError(f"context full: {int(self.seq_len.max())}+1 > {self.max_seq}")
        toks = torch.as_tensor(np.asarray(token_ids, np.int64), device=self.device)[:, None]
        logits = self._step(toks, self._dev_i32(self.seq_len), 1,
                            kv_cap=self._kv_cap(int(self.seq_len.max()) + 1))
        self.seq_len = self.seq_len + 1
        return logits[:, 0].cpu().numpy()

    def decode_greedy_tokens(self, first_tokens, n: int) -> np.ndarray:
        """Run n greedy decode steps; returns [B, n] int32 tokens. The token
        feedback and the write offsets stay on the device: one host round
        trip for the whole loop. first_tokens are step 0's input."""
        if int(self.seq_len.max()) + n > self.max_seq:
            raise ValueError(f"context full: {int(self.seq_len.max())}+{n} > {self.max_seq}")
        tok = torch.as_tensor(np.asarray(first_tokens, np.int64), device=self.device)
        write_pos = self._dev_i32(self.seq_len)
        out = torch.empty((self.batch_size, n), dtype=torch.int64, device=self.device)
        kv_cap = self._kv_cap(int(self.seq_len.max()) + n + 1)
        for i in range(n):
            logits = self._step(tok[:, None], write_pos, 1, kv_cap=kv_cap)
            tok = logits[:, 0].argmax(dim=-1)
            out[:, i] = tok
            write_pos += 1
        self.seq_len = self.seq_len + n
        return out.cpu().numpy().astype(np.int32)
