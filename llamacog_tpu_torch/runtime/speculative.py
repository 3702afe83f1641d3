"""Speculative decoding: a draft model proposes, the target verifies the
whole draft in one step (PyTorch).

Counterpart of llamacog_tpu/runtime/speculative.py (the reference's
common/speculative.cpp:137-280): the draft extends greedily until its
confidence drops below p_min or n_draft is reached; the target runs the
whole draft batch in ONE forward and keeps the longest prefix that agrees
with its own choices. Two implementations:

* SpeculativeDecoder: host-driven, sampler-aware, per slot (the server's
  -md). The verify is Engine.prefill_logits (one padded prefill step with
  the logits of every position); the rollback of both engines is by host
  seq_len, and the draft replays the accepted tokens.
* OnDeviceSpeculative: greedy only, the draft -> verify -> accept round on
  the device (--spec-ondevice). The JAX package runs its rounds in one
  jitted lax.while_loop; here one round is one CUDA graph per (t_cap,
  d_cap) bucket, replayed as many rounds as cannot run past the stop, with
  one 4-byte read of the emitted count between batches of replays.

Neither runs over a sliding-window ring cache (SwaKVCache): a rollback
writes seq_len back below the row's length, and the ring would keep the
rejected tokens' K/V in slots it reads as older positions (the JAX package
rolls back all the same, speculative.py:207-209,275-278). Both refuse an
engine that holds the ring.
"""

from __future__ import annotations

import gc
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.cuda import build
from .engine import Engine
from .sampler import SamplerChain, _softmax


def truncated_draft_params(params: dict, n_layers: int) -> dict:
    """Self-speculative draft: the target's first n_layers plus its own
    embedding, norm and head, sharing every tensor (no copy, no extra device
    memory); its config is ``dataclasses.replace(cfg, n_layer=n_layers)``.
    The early-exit draft of LayerSkip / Draft&Verify, without trained exit
    heads."""
    draft = dict(params)
    draft["layers"] = params["layers"][:n_layers]
    return draft


def refuse_ring(*engines: Engine) -> None:
    """Speculation rolls a row back below its length, which a ring row
    cannot take (Engine.set_seq_len refuses it): refuse the ring by name."""
    for e in engines:
        if e.ring:
            raise ValueError("speculative decoding over a sliding-window ring cache "
                             "(SwaKVCache) is not supported: a rollback would leave the "
                             "rejected tokens' K/V in the ring")


class OnDeviceSpeculative:
    """Greedy speculative decoding with no per-token host traffic.

    Each round: k + 1 draft T = 1 steps, each taking the argmax (the + 1
    keeps the draft cache complete when all k drafts are accepted); one
    target step over [cur, d0 .. d(k-1)] at T = k + 1, unpadded, with the
    logits of every position; n_acc, the length of the agreeing prefix;
    the emitted tokens written to ``out`` at n_out; cur, the row lengths,
    n_out and the accept and round counts advanced on the device. Greedy-
    exact: the emitted tokens are Engine.decode_greedy_tokens' on the
    target (a kept token is one the target itself picked).

    On the GPU the round is captured once per (t_cap, d_cap) bucket as a
    CUDA graph, as DecodeStep captures decode: static device buffers for
    every input, an eager warm-up round on a side stream with the state
    saved and put back, the collector held off during the capture. A
    failed capture or replay raises; nothing falls back to decoding token
    by token. On the CPU the same round function runs eagerly."""

    def __init__(self, target: Engine, draft: Engine, k: int = 4):
        if target.batch_size != 1 or draft.batch_size != 1:
            raise ValueError("OnDeviceSpeculative takes single-row engines (batch_size 1)")
        if target.device != draft.device:
            raise ValueError(f"target on {target.device}, draft on {draft.device}")
        refuse_ring(target, draft)
        self.target, self.draft, self.k = target, draft, k
        dev = target.device
        i64 = dict(dtype=torch.int64, device=dev)
        self.cur = torch.zeros((1, 1), **i64)
        self.t_seq = torch.zeros(1, dtype=torch.int32, device=dev)
        self.d_seq = torch.zeros(1, dtype=torch.int32, device=dev)
        self.n_out = torch.zeros(1, **i64)
        self.acc = torch.zeros(1, **i64)
        self.rnd = torch.zeros(1, **i64)
        # a round writes k + 1 tokens at n_out < n <= max_seq
        self.out = torch.zeros(target.max_seq + k + 1, **i64)
        self._idx = torch.arange(k + 1, **i64)
        self.graphs: dict = {}  # (t_cap, d_cap) -> (CUDA graph, the launches it captured)
        self._pool = torch.cuda.graph_pool_handle() if dev.type == "cuda" else None
        self.host_reads = 0  # device-to-host copies of the last generate_greedy
        self.replays = 0     # rounds of the last generate_greedy

    def round(self, t_cap, d_cap) -> None:
        """One draft -> verify -> accept round on the static buffers (the
        body of the JAX while_loop, speculative.py:73-102)."""
        k, t, d = self.k, self.target, self.draft
        tok, drafts = self.cur, []
        for i in range(k + 1):
            logits = d._step(tok, self.d_seq + i, 1, kv_cap=d_cap)[:, 0]
            tok = logits.argmax(dim=-1, keepdim=True)  # [1, 1]
            drafts.append(tok)
        drafts = torch.cat(drafts, dim=1)[0]  # [k + 1]
        batch = torch.cat([self.cur, drafts[None, :k]], dim=1)  # [1, k + 1]
        choice = t._step(batch, self.t_seq, k + 1, kv_cap=t_cap)[0].argmax(dim=-1)
        agree = (choice[:k] == drafts[:k]).long()
        n_acc = torch.cumprod(agree, 0).sum(0, keepdim=True)  # [1]
        emit = torch.where(self._idx < n_acc, drafts,
                           choice.gather(0, torch.minimum(self._idx, n_acc)))
        self.out.scatter_(0, self.n_out + self._idx, emit)
        self.cur.copy_(choice.gather(0, n_acc).view(1, 1))
        step = (n_acc + 1).to(torch.int32)
        self.t_seq += step
        self.d_seq += step
        self.n_out += n_acc + 1
        self.acc += n_acc
        self.rnd += 1

    def _capture(self, t_cap, d_cap):
        state = (self.cur, self.t_seq, self.d_seq, self.n_out, self.acc, self.rnd, self.out)
        saved = [s.clone() for s in state]
        dev = self.target.device
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self.round(t_cap, d_cap)
        main.wait_stream(side)
        for s, v in zip(state, saved):
            s.copy_(v)
        graph = torch.cuda.CUDAGraph()
        # as DecodeStep._capture: no collection of a dead graph during the
        # capture, and other threads' CUDA calls left alone
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with build.capturing_launches() as launches:
                with torch.cuda.graph(graph, pool=self._pool,
                                      capture_error_mode="thread_local"):
                    self.round(t_cap, d_cap)
        finally:
            if collecting:
                gc.enable()
        self.graphs[(t_cap, d_cap)] = (graph, launches)
        return graph, launches

    def _run(self, t_cap, d_cap, rounds: int, eager: bool) -> None:
        if eager or self.target.device.type != "cuda":
            for _ in range(rounds):
                self.round(t_cap, d_cap)
            return
        graph, launches = self.graphs.get((t_cap, d_cap)) or self._capture(t_cap, d_cap)
        for _ in range(rounds):
            graph.replay()
        build.add_launches(launches, rounds)

    def generate_greedy(self, first_token: int, n: int, eager: bool = False):
        """Decode n greedy tokens on the device; returns (tokens [n] int32,
        stats), and sets both engines' seq_len to the rows' final lengths
        (speculative.py:111-129). Both engines must hold the same prefilled
        context. The JAX loop stops once n tokens are out; a round emits
        between 1 and k + 1, so R = ceil((n - n_out) / (k + 1)) rounds never
        run past the stop: R replays, one read of n_out, until n are out.
        With eager the round function is called from Python every round
        instead of replayed (the yardstick the graph is held against)."""
        t, d, k = self.target, self.draft, self.k
        t0, d0 = int(t.seq_len[0]), int(d.seq_len[0])
        for e, s0 in ((t, t0), (d, d0)):
            if s0 + n + k > e.max_seq:
                raise ValueError(f"context full: {s0}+{n}+{k} > max_seq {e.max_seq}")
        t_cap = t._kv_cap(t0 + n + k + 2)
        d_cap = d._kv_cap(d0 + n + k + 2)
        self.cur.fill_(int(first_token))
        self.t_seq.fill_(t0)
        self.d_seq.fill_(d0)
        for s in (self.n_out, self.acc, self.rnd):
            s.zero_()
        done = reads = replays = 0
        while done < n:
            rounds = -(-(n - done) // (k + 1))
            self._run(t_cap, d_cap, rounds, eager)
            replays += rounds
            done = int(self.n_out[0])
            reads += 1
        lens = torch.cat([self.t_seq.long(), self.d_seq.long(), self.acc, self.rnd]).cpu()
        out = self.out[:n].cpu().numpy().astype(np.int32)
        self.host_reads, self.replays = reads + 2, replays
        t_seq, d_seq, acc, rnd = (int(v) for v in lens)
        t.seq_len[0], d.seq_len[0] = t_seq, d_seq
        stats = {"rounds": rnd, "drafted": rnd * k, "accepted": acc,
                 "accept_rate": float(acc) / max(rnd * k, 1)}
        return out, stats


@dataclass
class SpeculativeParams:
    n_draft: int = 8
    n_min: int = 0
    p_min: float = 0.75


class SpeculativeDecoder:
    def __init__(self, target: Engine, draft: Engine, params: SpeculativeParams | None = None):
        refuse_ring(target, draft)
        self.target = target
        self.draft = draft
        self.p = params or SpeculativeParams()

    def _draft_tokens(self, last_token: int, row: int = 0) -> list[int]:
        """Greedy draft until confidence drops (speculative.cpp:243-274):
        the p_min gate on float64 softmax probabilities."""
        out: list[int] = []
        tok = last_token
        active = np.zeros(self.draft.batch_size, dtype=bool)
        active[row] = True
        for _ in range(self.p.n_draft):
            toks = np.zeros(self.draft.batch_size, dtype=np.int32)
            toks[row] = tok
            logits = self.draft.decode_one(toks, active=active)[row]
            probs = _softmax(logits.astype(np.float64))
            nxt = int(probs.argmax())
            if probs[nxt] < self.p.p_min and len(out) >= self.p.n_min:
                break
            out.append(nxt)
            tok = nxt
        return out

    def step_slot(self, row: int, last_token: int, pick, max_accept: int,
                  stats: dict | None = None) -> tuple[list[int], int]:
        """One speculative round for one slot (server.cpp:3559-3584 role):
        drafts a continuation of `last_token` on the draft engine's `row`,
        verifies the whole draft in ONE target prefill_logits call, rolls
        both rows back to the accepted prefix, and returns
        (accepted_draft_tokens, next_token). `pick(logits) -> token` is the
        slot's sampler; rejected sampling restarts from the target's choice."""
        save_len = int(self.target.seq_len[row])
        draft_save = int(self.draft.seq_len[row])  # lockstep with target
        draft = self._draft_tokens(last_token, row=row)
        if not draft:
            toks = np.zeros(self.target.batch_size, dtype=np.int32)
            toks[row] = last_token
            active = np.zeros(self.target.batch_size, dtype=bool)
            active[row] = True
            logits = self.target.decode_one(toks, active=active)[row]
            return [], pick(logits)
        logits_all = self.target.prefill_logits([last_token] + draft, row=row)
        n_acc = 0
        next_tok = None
        for i, d in enumerate(draft):
            t_choice = pick(logits_all[i])
            if t_choice == d and n_acc < max_accept:
                n_acc += 1
            else:
                next_tok = t_choice
                break
        if next_tok is None:
            next_tok = pick(logits_all[len(draft)])
        if stats is not None:
            stats["drafted"] = stats.get("drafted", 0) + len(draft)
            stats["accepted"] = stats.get("accepted", 0) + n_acc
            stats["rounds"] = stats.get("rounds", 0) + 1
        accepted = draft[:n_acc]
        # KV rollback to the accepted prefix (llama-context.cpp:1014-1035)
        self.target.seq_len[row] = save_len + 1 + n_acc
        # resync the draft: rewind past the speculation and replay the accepted
        self.draft.seq_len[row] = draft_save
        active = np.zeros(self.draft.batch_size, dtype=bool)
        active[row] = True
        for t in [last_token] + accepted:
            toks = np.zeros(self.draft.batch_size, dtype=np.int32)
            toks[row] = t
            self.draft.decode_one(toks, active=active)
        return accepted, next_tok

    def generate(self, prompt_tokens: list[int], max_new_tokens: int,
                 sampler: SamplerChain | None = None, eog_ids=()) -> tuple[list[int], dict]:
        """The single-stream loop: returns (tokens, stats). With a sampler
        the draws run in the JAX loop's order (each accepted draft token is
        accepted into the chain as it is kept)."""
        t_logits = self.target.prefill(prompt_tokens)
        self.draft.prefill(prompt_tokens)

        def pick(logits) -> int:
            if sampler is not None:
                return sampler.sample(logits)
            return int(np.argmax(logits))

        out: list[int] = []
        stats = {"drafted": 0, "accepted": 0, "rounds": 0}
        cur = pick(t_logits)
        while len(out) < max_new_tokens:
            out.append(cur)
            if cur in eog_ids:
                break
            draft = self._draft_tokens(cur)
            stats["drafted"] += len(draft)
            stats["rounds"] += 1
            if not draft:  # a plain decode step
                t_logits = self.target.decode_one(np.array([cur] * self.target.batch_size))[0]
                cur = pick(t_logits)
                continue
            # the target verifies [cur, d0 .. dk-1] in one call
            save_len = int(self.target.seq_len[0])
            logits_all = self.target.prefill_logits([cur] + draft, row=0)
            n_acc = 0
            next_tok = None
            for i, d in enumerate(draft):
                t_choice = pick(logits_all[i])
                if t_choice == d and len(out) + n_acc < max_new_tokens:
                    n_acc += 1
                    if sampler is not None:
                        sampler.accept(d)
                else:
                    next_tok = t_choice
                    break
            if next_tok is None:
                next_tok = pick(logits_all[len(draft)])
            accepted = draft[:n_acc]
            stats["accepted"] += n_acc
            out.extend(accepted)
            # roll the target back to the accepted tokens, rewind the draft
            # past its speculation and replay them
            self.target.seq_len[0] = save_len + 1 + n_acc
            self.draft.seq_len[0] = save_len
            for t in [cur] + accepted:
                self.draft.decode_one(np.array([t] * self.draft.batch_size))
            cur = next_tok
        return out[:max_new_tokens], stats
