"""Single-stream generation engine (PyTorch).

Counterpart of llamacog_tpu/runtime/engine.py::Engine for the llama path,
with the dense cache or the quantized one (kv_type, the -ctk/-ctv kinds,
through make_cache): prefill in padded length buckets (the pad slots are
written to the cache, as the JAX engine writes them), one-token decode
steps, and a greedy loop that keeps the token on the device. The cache bound `_kv_cap`
is the JAX engine's. With ``LLAMACOG_MMQ=1`` (read at construction, as
engine.py:59 reads it) the engine attaches int8 prefill planes to its own
copy of the params (quant/mmq.py), so prefill chunks of MMQ_MIN_B rows or
more take the int8 GEMM. Prefill runs eagerly. Decode runs through
:class:`DecodeStep`: on the GPU one CUDA graph of the T = 1 step per
kv_cap bucket, replayed once a token (the counterpart of the JAX engine's
jitted step and its on-device greedy loop, engine.py:137-151,226-252); on
the CPU the same step function runs eagerly into the same buffers.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..models.config import ModelConfig
from ..models.llama import check_supported, forward
from ..ops.cuda import build
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


@dataclass
class GenerationResult:
    tokens: list[int]
    logits: np.ndarray | None = None


def _param_devices(params: dict) -> set:
    tensors = [v for k, v in params.items() if k != "layers"]
    tensors += [v for layer in params["layers"] for v in layer.values()]
    return {t.device for t in tensors}


class DecodeStep:
    """The T = 1 decode step on static device buffers: the input token
    ``tok`` [B, 1], the cache write offsets ``write_pos`` [B] int32, the
    in-graph step index ``index`` [B, 1] (the column of ``out`` the step
    writes), the greedy tokens ``out`` [B, max_steps] and the step's f32
    logits [B, V]. One step runs forward, takes the argmax, writes it to
    ``out`` and feeds it back as the next input, and advances ``write_pos``
    and ``index``: the body of the JAX engine's greedy fori_loop.

    On the GPU the step is captured in a CUDA graph once per kv_cap bucket,
    all graphs in one memory pool, and :meth:`run` replays it. Before a
    capture the step runs once eagerly on a side stream with the buffers
    saved and put back: that builds and loads every library the step
    launches and lets each kernel set its attributes, none of which may
    happen under capture. Everything the step reads is on the device or
    fixed for the bucket (the split counts follow kv_cap; the routes read
    from the environment are fixed at capture, as jit fixes them at trace).
    A failed capture or replay raises. On the CPU :meth:`run` calls the
    step function itself."""

    def __init__(self, batch_size: int, n_vocab: int, max_steps: int, device: torch.device):
        self.device = device
        i64 = dict(dtype=torch.int64, device=device)
        self.tok = torch.zeros((batch_size, 1), **i64)
        self.write_pos = torch.zeros(batch_size, dtype=torch.int32, device=device)
        self.index = torch.zeros((batch_size, 1), **i64)
        self.out = torch.zeros((batch_size, max_steps), **i64)
        self.logits = torch.zeros((batch_size, n_vocab), dtype=torch.float32, device=device)
        self.graphs: dict = {}  # kv_cap -> (CUDA graph, the launches it captured)
        self._pool = torch.cuda.graph_pool_handle() if device.type == "cuda" else None

    def load(self, tokens, seq_len: np.ndarray) -> None:
        """The first input tokens [B] and the host lengths; step index 0."""
        self.tok.copy_(torch.as_tensor(np.asarray(tokens, np.int64).reshape(-1, 1)))
        self.write_pos.copy_(torch.as_tensor(np.asarray(seq_len, np.int32)))
        self.index.zero_()

    def step(self, forward_step, kv_cap) -> None:
        """One decode step; forward_step(tokens, write_pos, t, kv_cap=)
        returns the [B, 1, V] f32 logits and writes the cache in place."""
        logits = forward_step(self.tok, self.write_pos, 1, kv_cap=kv_cap)[:, 0]
        self.logits.copy_(logits)
        nxt = logits.argmax(dim=-1, keepdim=True)
        self.out.scatter_(1, self.index, nxt)
        self.tok.copy_(nxt)
        self.write_pos += 1
        self.index += 1

    def run_eager(self, forward_step, kv_cap, n: int) -> None:
        """n calls of :meth:`step`: the CPU's run, and on the GPU the
        yardstick the graph is held and timed against."""
        for _ in range(n):
            self.step(forward_step, kv_cap)

    def run(self, forward_step, kv_cap, n: int) -> None:
        """n steps: n replays of the bucket's graph on the GPU (captured on
        first use), :meth:`run_eager` on the CPU."""
        if self.device.type != "cuda":
            return self.run_eager(forward_step, kv_cap, n)
        graph, launches = self.graphs.get(kv_cap) or self._capture(forward_step, kv_cap)
        for _ in range(n):
            graph.replay()
        build.add_launches(launches, n)

    def _capture(self, forward_step, kv_cap):
        state = (self.tok, self.write_pos, self.index)
        saved = [t.clone() for t in state]
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self.step(forward_step, kv_cap)
        main.wait_stream(side)
        for t, v in zip(state, saved):
            t.copy_(v)
        graph = torch.cuda.CUDAGraph()
        with build.capturing_launches() as launches:
            with torch.cuda.graph(graph, pool=self._pool):
                self.step(forward_step, kv_cap)
        self.graphs[kv_cap] = (graph, launches)
        return graph, launches


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
        self.decoder = DecodeStep(batch_size, config.n_vocab, max_seq, self.device)

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

    def _check_room(self, n: int) -> None:
        if int(self.seq_len.max()) + n > self.max_seq:
            raise ValueError(f"context full: {int(self.seq_len.max())}+{n} > {self.max_seq}")

    def decode_one(self, token_ids) -> np.ndarray:
        """One decode step for all rows: token_ids [B] -> logits [B, V]
        (one replay of the step's graph on the GPU)."""
        self._check_room(1)
        self.decoder.load(token_ids, self.seq_len)
        self.decoder.run(self._step, self._kv_cap(int(self.seq_len.max()) + 1), 1)
        self.seq_len = self.seq_len + 1
        return self.decoder.logits.to("cpu", copy=True).numpy()

    def decode_greedy_tokens(self, first_tokens, n: int) -> np.ndarray:
        """Run n greedy decode steps; returns [B, n] int32 tokens. The token
        feedback and the write offsets stay on the device (n replays of the
        step's graph on the GPU): one host round trip for the whole loop.
        first_tokens are step 0's input."""
        return self._greedy(first_tokens, n, self.decoder.run)

    def decode_greedy_tokens_eager(self, first_tokens, n: int) -> np.ndarray:
        """decode_greedy_tokens with the step function called from Python
        every token instead of replayed: the yardstick the graph is held
        and timed against (chip_smoke.py, tools/profile.py)."""
        return self._greedy(first_tokens, n, self.decoder.run_eager)

    def _greedy(self, first_tokens, n: int, run) -> np.ndarray:
        self._check_room(n)
        self.decoder.load(first_tokens, self.seq_len)
        run(self._step, self._kv_cap(int(self.seq_len.max()) + n + 1), n)
        self.seq_len = self.seq_len + n
        return self.decoder.out[:, :n].cpu().numpy().astype(np.int32)

    def generate_greedy(self, prompt_tokens: list[int], max_new_tokens: int,
                        eog_ids=()) -> GenerationResult:
        """Prefill, then greedy tokens up to max_new_tokens or an EOG id
        (engine.py:654-683): one decode_greedy_tokens loop, or decode_one
        steps for max_new_tokens <= 1, as there."""
        logits = self.prefill(prompt_tokens)
        out = []
        tok = int(np.argmax(logits))
        if max_new_tokens > 1:
            out.append(tok)
            if tok in eog_ids:
                return GenerationResult(tokens=out)
            n = min(max_new_tokens - 1, self.max_seq - int(self.seq_len[0]) - 1)
            if n > 0:
                toks = self.decode_greedy_tokens(np.array([tok] * self.batch_size), n)[0]
                for t in toks:
                    out.append(int(t))
                    if int(t) in eog_ids:
                        break
            return GenerationResult(tokens=out)
        for _ in range(max_new_tokens):
            out.append(tok)
            if tok in eog_ids:
                break
            if int(self.seq_len[0]) >= self.max_seq:
                break
            logits = self.decode_one(np.array([tok] * self.batch_size))
            tok = int(np.argmax(logits[0]))
        return GenerationResult(tokens=out)
