"""llamacog-server — OpenAI-compatible HTTP server with slot-based
continuous batching (PyTorch port).

Counterpart of llamacog_tpu/server/server.py. HTTP threads enqueue tasks;
ONE inference thread owns the engine and runs the reference's
update_slots loop (server.cpp:2960): admit queued prompts into idle slots
(routed by longest common prefix), prefill one chunk of one prompt a
round (prefix reuse, chunks of PREFILL_CHUNK tokens), then decode one token
for every generating slot in one batched step (Engine.decode_one with the
slots' active mask: one replay of the step's CUDA graph on the GPU);
results stream back through per-task queues (SSE). A slot whose context
fills shifts it (Engine.shift_row) unless context shift is off.

Endpoints: /health, /props, /metrics, /slots, /v1/models, /completion(s),
/v1/completions, /chat/completions, /v1/chat/completions, /api/chat,
/tokenize, /detokenize, /apply-template, /infill, the web UI at /, and the
ollama-compatible /api/tags and /api/show.

Not ported yet, each refused by name (a constructor argument raises
NotImplementedError, an endpoint answers HTTP 501 with the same words):
speculative decoding (host and on-device), multimodal input (--mmproj),
LoRA adapters and control vectors, the multi-host mirror, embeddings and
rerank (they need models/bert.py) and slot save/restore (it needs
runtime/state.py).
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
import uuid
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from ..models.loader import Model
from ..runtime.engine import Engine
from ..runtime.grammar import grammar_from_gbnf
from ..runtime.json_schema import json_schema_to_gbnf
from ..runtime.sampler import SamplerChain, SamplerParams

IDLE, PROMPT, GENERATING = 0, 1, 2

# max prompt tokens prefilled per update_slots iteration (the reference's
# n_ubatch chunking, server.cpp:3320) so decode interleaves with long prompts
PREFILL_CHUNK = int(os.environ.get("LLAMACOG_PREFILL_CHUNK", "512"))


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet")


@dataclass
class Task:
    id: str
    prompt_ids: list
    params: SamplerParams
    n_predict: int
    stream: bool
    stop_strings: list
    grammar_text: str | None
    out: "queue.Queue" = field(default_factory=queue.Queue)
    kind: str = "completion"  # completion | chat
    cache_prompt: bool = True  # prefix-cache reuse (server.cpp cache_prompt)
    cancelled: bool = False
    n_keep: int = 0  # context-shift keep prefix (-1 = whole prompt)
    ignore_eos: bool = False  # keep generating past EOG (server.cpp ignore_eos)
    return_tokens: bool = False  # the final message carries the generated ids


class Slot:
    def __init__(self, sid: int):
        self.id = sid
        self.state = IDLE
        self.task: Task | None = None
        self.sampler: SamplerChain | None = None
        self.n_gen = 0
        self.text = ""
        self.t_start = 0.0
        self.t_first_token = 0.0
        self.next_token: int | None = None
        self.cache_tokens: list[int] = []  # tokens currently in this row's KV
        self.n_sent = 0  # chars of self.text already streamed out
        self.prompt_ids: list[int] | None = None  # truncated prompt (set on
        # first prefill chunk)
        self.prompt_pos = 0  # tokens of prompt_ids already prefilled
        self.n_cached = 0  # prompt tokens reused from the row's KV
        self.generated: list[int] = []  # token ids emitted for the task
        self.finished = False  # set by _emit_token when the slot is done


class ServerContext:
    def __init__(
        self, model: Model, n_slots: int = 4, ctx_size: int = 2048, dtype=None,
        loras=None, mesh=None, vision=None, draft_model: Model | None = None,
        ctx_shift: bool = True, kv_type: str = "dense",
        spec_ondevice: int = 0, spec_k: int = 4, device=None,
    ):
        """The JAX server's arguments; those of the parts not ported yet
        raise by name. `device` is the engine's (None: CUDA; the CPU only
        when asked for), where the model's params must live."""
        refused = {"LoRA adapters": bool(loras), "the multi-host mirror": mesh is not None,
                   "multimodal input (--mmproj)": vision is not None,
                   "speculative decoding (-md)": draft_model is not None,
                   "on-device speculative decoding (--spec-ondevice)": bool(spec_ondevice)}
        for what, asked in refused.items():
            if asked:
                raise not_ported(what)
        self.model = model
        self.engine = Engine(
            model.params, model.config, batch_size=n_slots,
            max_seq=ctx_size, dtype=dtype or torch.bfloat16, kv_type=kv_type,
            device=device,
        )
        self.ctx_shift = ctx_shift
        self.slots = [Slot(i) for i in range(n_slots)]
        self.pending: "queue.Queue[Task]" = queue.Queue()
        self.ctx_size = ctx_size
        self.metrics = {
            "prompt_tokens_total": 0,
            "tokens_predicted_total": 0,
            "requests_total": 0,
            "t_start": time.time(),
        }
        self._stop = False
        self.thread = threading.Thread(target=self._loop, daemon=True)

    def start(self):
        self.thread.start()

    def stop(self):
        """End the inference loop and wait for its thread."""
        self._stop = True
        if self.thread.is_alive():
            self.thread.join(timeout=60)

    # -- inference loop ------------------------------------------------------
    @staticmethod
    def _lcp(a, b) -> int:
        n = 0
        m = min(len(a or ()), len(b or ()))
        while n < m and a[n] == b[n]:
            n += 1
        return n

    def _admit(self) -> None:
        while any(s.state == IDLE for s in self.slots):
            try:
                task = self.pending.get_nowait()
            except queue.Empty:
                return
            if task.cancelled:
                continue
            # slot routing by longest common prompt prefix (the reference's
            # slot_prompt_similarity selection, server.cpp get_available_slot):
            # reusing the slot whose KV already holds the prompt's prefix
            # turns cross-request prefix caching into a hit instead of a miss
            idle = [s for s in self.slots if s.state == IDLE]
            slot = max(
                idle,
                key=lambda s: (self._lcp(s.cache_tokens, task.prompt_ids)
                               if task.cache_prompt else 0, -s.id),
            )
            slot.task = task
            slot.state = PROMPT
            slot.n_gen = 0
            slot.text = ""
            slot.n_sent = 0
            slot.prompt_ids = None
            slot.prompt_pos = 0
            slot.n_cached = 0
            slot.generated = []
            slot.finished = False
            slot.t_start = time.time()
            grammar = None
            if task.grammar_text:
                try:
                    grammar = grammar_from_gbnf(task.grammar_text, self.model.vocab)
                except Exception as e:
                    task.out.put({"error": f"grammar parse error: {e}"})
                    slot.state = IDLE
                    slot.task = None
                    continue
            slot.sampler = SamplerChain(
                task.params, n_vocab=self.model.config.n_vocab, grammar=grammar,
                tokenizer=self.model.tokenizer,
            )

    def _prefill_one(self) -> None:
        for slot in self.slots:
            if slot.state != PROMPT:
                continue
            task = slot.task
            if slot.prompt_ids is None:
                ids = task.prompt_ids
                if len(ids) >= self.ctx_size:
                    # keep a positive prompt tail even when n_predict >=
                    # ctx_size (the reference clamps n_predict to the
                    # remaining context, server.cpp, instead of failing)
                    keep = max(self.ctx_size - max(task.n_predict, 16), 16)
                    ids = ids[-keep:]
                if not self.ctx_shift:
                    # without context shift a slot cannot outlive its
                    # context: clamp n_predict to the remaining room
                    task.n_predict = max(
                        min(task.n_predict, self.ctx_size - len(ids)), 1
                    )
                # prompt prefix-cache reuse (server.cpp:3191-3260): keep the
                # common prefix already in this row's KV, prefill only the
                # new suffix (at least one token, so we get logits)
                n_common = 0
                if task.cache_prompt and slot.cache_tokens:
                    limit = min(len(slot.cache_tokens), len(ids) - 1)
                    while n_common < limit and slot.cache_tokens[n_common] == ids[n_common]:
                        n_common += 1
                if n_common > 0:
                    self.engine.set_seq_len(slot.id, n_common)
                else:
                    self.engine.clear_row(slot.id)
                slot.prompt_ids = list(ids)
                slot.prompt_pos = n_common
                slot.n_cached = n_common
                self.metrics["prompt_tokens_cached_total"] = (
                    self.metrics.get("prompt_tokens_cached_total", 0) + n_common
                )
            # chunked prefill: at most PREFILL_CHUNK tokens per loop
            # iteration so generating slots keep decoding between chunks
            # (server.cpp:3191-3260 n_ubatch interleave)
            ids = slot.prompt_ids
            end = min(slot.prompt_pos + PREFILL_CHUNK, len(ids))
            chunk = ids[slot.prompt_pos:end]
            logits = self.engine.prefill(chunk, row=slot.id)
            slot.prompt_pos = end
            self.metrics["prompt_tokens_total"] += len(chunk)
            if end == len(ids):
                slot.cache_tokens = list(ids)
                slot.next_token = slot.sampler.sample(logits)
                slot.t_first_token = time.time()
                slot.state = GENERATING
            return  # one chunk per loop iteration (prefill/decode interleave)

    def _emit_token(self, slot: Slot, tok: int) -> bool:
        """Accept + stream one generated token; returns True when the slot
        finished (and has been released)."""
        vocab = self.model.vocab
        slot.sampler.accept(tok)
        slot.cache_tokens.append(tok)
        slot.generated.append(tok)
        piece = vocab.token_to_piece(tok).decode("utf-8", errors="replace")
        slot.text += piece
        slot.n_gen += 1
        self.metrics["tokens_predicted_total"] += 1
        task = slot.task
        finished = (
            (vocab.is_eog(tok) and not task.ignore_eos)
            or slot.n_gen >= task.n_predict
            or (not self.ctx_shift
                and int(self.engine.seq_len[slot.id]) + 1 >= self.ctx_size)
            or task.cancelled
            or any(stop in slot.text for stop in task.stop_strings)
        )
        # truncate at the stop string (reference server behavior)
        final_text = slot.text
        for s in task.stop_strings:
            idx = final_text.find(s)
            if idx >= 0:
                final_text = final_text[:idx]
        if task.stream and not vocab.is_eog(tok):
            # hold back any suffix that could become a stop string
            # (string_find_partial_stop role; runtime/partial.py), and never
            # stream past a stop string that has appeared (the JAX server
            # streams the text through the stop string on the token that
            # completes it)
            hold = 0
            if task.stop_strings and not finished:
                from ..runtime.partial import partial_stop_match

                hold = max(
                    partial_stop_match(slot.text, s) for s in task.stop_strings
                )
            emit_to = len(final_text) if finished else len(slot.text) - hold
            if emit_to > slot.n_sent:
                task.out.put({
                    "content": slot.text[slot.n_sent:emit_to], "stop": False
                })
                slot.n_sent = emit_to
        if finished:
            t_now = time.time()
            if task.stream:
                tail = final_text[slot.n_sent:]
                content = tail if tail and not vocab.is_eog(tok) else ""
            else:
                content = final_text
            # llama.cpp's timings names: prompt_ms from the slot's admission
            # to its first token, cache_n the prompt tokens reused
            timings = {
                "prompt_n": len(task.prompt_ids),
                "cache_n": slot.n_cached,
                "prompt_ms": (slot.t_first_token - slot.t_start) * 1000.0,
                "predicted_n": slot.n_gen,
                "predicted_ms": (t_now - slot.t_first_token) * 1000.0,
            }
            final = {
                "content": content,
                "stop": True,
                "stop_reason": "eos" if vocab.is_eog(tok) else "limit",
                "tokens_predicted": slot.n_gen,
                "timings": timings,
            }
            if task.return_tokens:
                final["tokens"] = list(slot.generated)
            task.out.put(final)
            slot.state = IDLE
            slot.task = None
            slot.sampler = None
            slot.finished = True
        return finished

    def _maybe_context_shift(self, slot: Slot, headroom: int = 1) -> None:
        """Per-slot context shift (server.cpp:2993-3030): when the row's
        context cannot fit `headroom` more tokens, discard half of the
        non-kept tokens and slide the rest down (on-device gather+re-rope,
        Engine.shift_row)."""
        if not self.ctx_shift or slot.task is None:
            return
        cur = int(self.engine.seq_len[slot.id])
        if cur + headroom < self.ctx_size:
            return
        task = slot.task
        n_keep = task.n_keep
        if n_keep < 0:
            n_keep = len(slot.prompt_ids or task.prompt_ids)
        n_keep = min(n_keep, self.ctx_size // 2)
        n_discard = max((cur - n_keep) // 2, headroom)
        self.engine.shift_row(slot.id, n_keep, n_discard)
        del slot.cache_tokens[n_keep:n_keep + n_discard]
        self.metrics["context_shifts_total"] = (
            self.metrics.get("context_shifts_total", 0) + 1
        )

    def _decode_step(self) -> None:
        gen = [s for s in self.slots if s.state == GENERATING]
        if not gen:
            return
        # emit the token each slot currently holds
        for slot in gen:
            self._emit_token(slot, slot.next_token)
        gen = [s for s in self.slots if s.state == GENERATING]
        if not gen:
            return
        # batch decode one token for every generating slot
        for slot in gen:
            self._maybe_context_shift(slot)
        toks = np.zeros(len(self.slots), dtype=np.int32)
        active = np.zeros(len(self.slots), dtype=bool)
        for slot in gen:
            toks[slot.id] = slot.next_token
            active[slot.id] = True
        logits = self.engine.decode_one(toks, active=active)
        for slot in gen:
            slot.next_token = slot.sampler.sample(logits[slot.id])

    def _loop(self) -> None:
        import traceback

        while not self._stop:
            try:
                self._admit()
                busy = any(s.state != IDLE for s in self.slots)
                if not busy:
                    try:
                        task = self.pending.get(timeout=0.05)
                        self.pending.put(task)
                    except queue.Empty:
                        continue
                    continue
                self._prefill_one()
                self._decode_step()
            except Exception as e:  # keep serving; fail the affected slots
                traceback.print_exc()
                for slot in self.slots:
                    if slot.state != IDLE and slot.task is not None:
                        slot.task.out.put({"error": f"internal error: {e}"})
                        slot.state = IDLE
                        slot.task = None
                        slot.sampler = None

    # -- infill / slots --------------------------------------------------------
    def format_infill(self, body: dict) -> list[int]:
        """FIM prompt assembly (reference tools/server/utils.hpp:360-392):
        [BOS] extra [FIM_PRE] prefix prompt [FIM_SUF] suffix [FIM_MID]
        (suffix-first when the model wants SPM order)."""
        v = self.model.vocab
        tok = self._tokenizer()
        if v is None or v.fim_pre_id < 0 or v.fim_suf_id < 0 or v.fim_mid_id < 0:
            raise ValueError("model does not support infill (no FIM tokens)")
        prefix = tok.tokenize(str(body.get("input_prefix", "")), add_special=False)
        suffix = tok.tokenize(str(body.get("input_suffix", "")), add_special=False)
        prompt = body.get("prompt", "")
        prompt_ids = (
            [int(t) for t in prompt]
            if isinstance(prompt, list)
            else tok.tokenize(str(prompt), add_special=False)
        )
        extra: list[int] = []
        for chunk in body.get("input_extra", []) or []:
            text = str(chunk.get("text", ""))
            fname = str(chunk.get("filename", ""))
            if v.fim_rep_id >= 0 and fname:
                extra.append(v.fim_rep_id)
                extra += tok.tokenize(fname + "\n", add_special=False)
            if v.fim_sep_id >= 0:
                extra.append(v.fim_sep_id)
            extra += tok.tokenize(text, add_special=False)
        # budget: prefix:suffix = 3:1 of half the context
        n_batch = max(self.ctx_size // 2, 8)
        prefix = prefix[-(3 * n_batch // 4):]
        suffix = suffix[: max(0, n_batch // 4 - 2 - len(prompt_ids))]
        pre = [v.fim_pre_id] + prefix + prompt_ids
        suf = [v.fim_suf_id] + suffix
        spm = False  # PSM default; SPM models swap (tools/server/utils.hpp:376)
        ids = (suf + pre) if spm else (pre + suf)
        if v.add_bos and v.bos_id >= 0:
            ids = [v.bos_id] + ids
        return extra + ids + [v.fim_mid_id]


    def slot_action(self, slot_id: int, action: str, body: dict) -> dict:
        """POST /slots/:id?action=erase (reference tools/server/server.cpp:4861).
        save and restore are not ported yet: they need runtime/state.py."""
        if not (0 <= slot_id < len(self.slots)):
            raise ValueError(f"invalid slot id {slot_id}")
        if action in ("save", "restore"):
            raise not_ported("slot save/restore")
        if action == "erase":
            self.engine.clear_row(slot_id)
            self.slots[slot_id].state = IDLE
            self.slots[slot_id].task = None
            self.slots[slot_id].cache_tokens = []
            return {"id_slot": slot_id, "n_erased": 1}
        raise ValueError(f"unknown action {action!r}")

    # -- request handling ----------------------------------------------------
    def _tokenizer(self):
        if self.model.tokenizer is None:
            raise ValueError("the model was loaded without a tokenizer: send token ids")
        return self.model.tokenizer

    def apply_chat_template(self, messages, add_generation_prompt=True, tools=None) -> str:
        from ..runtime.chat import render_template

        template = self.model.vocab.chat_template if self.model.vocab else None
        v = self.model.vocab
        return render_template(
            template,
            messages,
            add_generation_prompt=add_generation_prompt,
            tools=tools,
            bos_token=v.tokens[v.bos_id] if v and v.bos_id >= 0 else "",
            eos_token=v.tokens[v.eos_id] if v and v.eos_id >= 0 else "",
        )


    def make_task(self, body: dict, kind: str) -> Task:
        if kind == "chat":
            messages = body.get("messages", [])
            if any(isinstance(m.get("content"), list) for m in messages):
                raise not_ported("multimodal input (--mmproj)")
            prompt = self.apply_chat_template(messages, tools=body.get("tools"))
        else:
            prompt = body.get("prompt", "")
        if isinstance(prompt, list):  # pre-tokenized
            ids = [int(t) for t in prompt]
        else:
            ids = self._tokenizer().tokenize(prompt, add_special=True, parse_special=True)
        grammar_text = body.get("grammar")
        schema = body.get("json_schema") or (
            body.get("response_format", {}).get("json_schema", {}).get("schema")
            if isinstance(body.get("response_format"), dict)
            and body["response_format"].get("type") == "json_schema"
            else None
        )
        if isinstance(body.get("response_format"), dict) and body["response_format"].get(
            "type"
        ) == "json_object" and not schema:
            schema = {}
        if schema is not None and not grammar_text:
            grammar_text = json_schema_to_gbnf(schema)
        params = SamplerParams(
            temp=float(body.get("temperature", 0.8)),
            top_k=int(body.get("top_k", 40)),
            top_p=float(body.get("top_p", 0.95)),
            min_p=float(body.get("min_p", 0.05)),
            typ_p=float(body.get("typical_p", 1.0)),
            penalty_last_n=int(body.get("repeat_last_n", 64)),
            penalty_repeat=float(body.get("repeat_penalty", 1.0)),
            penalty_freq=float(body.get("frequency_penalty", 0.0)),
            penalty_present=float(body.get("presence_penalty", 0.0)),
            dry_multiplier=float(body.get("dry_multiplier", 0.0)),
            dry_base=float(body.get("dry_base", 1.75)),
            dry_allowed_length=int(body.get("dry_allowed_length", 2)),
            dry_penalty_last_n=int(body.get("dry_penalty_last_n", -1)),
            dry_sequence_breaker_strings=tuple(
                body.get("dry_sequence_breakers", ["\n", ":", '"', "*"])
            ),
            seed=int(body.get("seed", -1)),
        )
        stops = body.get("stop", []) or []
        if isinstance(stops, str):
            stops = [stops]
        n_predict = int(
            body.get("n_predict", body.get("max_tokens", body.get("max_completion_tokens", 128)))
            or 128
        )
        task = Task(
            id=f"task-{uuid.uuid4().hex[:12]}",
            prompt_ids=ids,
            params=params,
            n_predict=n_predict,
            stream=bool(body.get("stream", False)),
            ignore_eos=bool(body.get("ignore_eos", False)),
            return_tokens=bool(body.get("return_tokens", False)),
            stop_strings=stops,
            grammar_text=grammar_text,
            kind=kind,
            cache_prompt=bool(body.get("cache_prompt", True)),
            n_keep=int(body.get("n_keep", 0)),
        )
        self.metrics["requests_total"] += 1
        return task



def make_handler(ctx: ServerContext):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            pass

        # -- helpers ------------------------------------------------------
        def _json(self, obj, code=200):
            data = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _read_body(self) -> dict:
            n = int(self.headers.get("Content-Length", 0))
            if not n:
                return {}
            return json.loads(self.rfile.read(n) or b"{}")

        def _sse_start(self):
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")
            self.end_headers()

        def _sse(self, obj):
            self.wfile.write(b"data: " + json.dumps(obj).encode() + b"\n\n")
            self.wfile.flush()

        # -- routes ---------------------------------------------------------
        def _not_ported(self, what: str):
            self._json({"error": {"message": str(not_ported(what))}}, 501)

        # -- routes ---------------------------------------------------------
        def do_GET(self):
            path = self.path.split("?")[0]
            if path in ("/", "/index.html"):
                from .webui import WEBUI_HTML

                data = WEBUI_HTML.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            elif path in ("/health", "/v1/health"):
                self._json({"status": "ok"})
            elif path == "/props":
                cfg = ctx.model.config
                self._json({
                    "model": cfg.metadata.get("general.name", "unknown"),
                    "n_ctx": ctx.ctx_size,
                    "total_slots": len(ctx.slots),
                    "chat_template": (ctx.model.vocab.chat_template or "")[:2000]
                    if ctx.model.vocab
                    else "",
                })
            elif path == "/api/tags":  # ollama compat (server.cpp:4815)
                name = ctx.model.config.metadata.get("general.name", "model")
                self._json({"models": [{
                    "name": name, "model": name,
                    "modified_at": "", "size": 0, "digest": "",
                    "details": {"family": ctx.model.config.arch,
                                "parameter_size": "", "quantization_level": ""},
                }]})
            elif path in ("/v1/models", "/models"):
                self._json({
                    "object": "list",
                    "data": [{
                        "id": ctx.model.config.metadata.get("general.name", "model"),
                        "object": "model",
                        "created": int(ctx.metrics["t_start"]),
                        "owned_by": "llamacog_tpu",
                    }],
                })
            elif path == "/metrics":
                m = ctx.metrics
                lines = []
                for key in ("prompt_tokens_total", "tokens_predicted_total", "requests_total",
                            "prompt_tokens_cached_total", "context_shifts_total"):
                    lines += [f"# TYPE llamacog:{key} counter",
                              f"llamacog:{key} {m.get(key, 0)}"]
                data = ("\n".join(lines) + "\n").encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            elif path == "/lora-adapters":
                self._not_ported("LoRA adapters")
            elif path == "/slots":
                self._json([
                    {
                        "id": s.id,
                        "state": s.state,
                        "n_past": int(ctx.engine.seq_len[s.id]),
                        "task": s.task.id if s.task else None,
                    }
                    for s in ctx.slots
                ])
            else:
                self._json({"error": "not found"}, 404)

        def do_POST(self):
            path = self.path.split("?")[0]
            try:
                body = self._read_body()
            except json.JSONDecodeError:
                self._json({"error": {"message": "invalid json"}}, 400)
                return
            if path in ("/completion", "/completions", "/v1/completions"):
                self._completion(body, openai=path.startswith("/v1"))
            elif path in ("/chat/completions", "/v1/chat/completions", "/api/chat"):
                self._chat(body)
            elif path == "/api/show":  # ollama compat (server.cpp:4815-4861)
                cfg = ctx.model.config
                self._json({
                    "template": (ctx.model.vocab.chat_template or "")
                    if ctx.model.vocab else "",
                    "model_info": {
                        "general.architecture": cfg.arch,
                        "general.name": cfg.metadata.get("general.name", "model"),
                        f"{cfg.arch}.context_length": cfg.n_ctx_train,
                        f"{cfg.arch}.embedding_length": cfg.n_embd,
                        f"{cfg.arch}.block_count": cfg.n_layer,
                    },
                    "capabilities": ["completion"],
                })
            elif path == "/tokenize":
                try:
                    tok = ctx._tokenizer()
                except ValueError as e:
                    self._json({"error": {"message": str(e)}}, 400)
                    return
                ids = tok.tokenize(
                    body.get("content", ""),
                    add_special=bool(body.get("add_special", False)),
                    parse_special=bool(body.get("parse_special", True)),
                )
                self._json({"tokens": ids})
            elif path == "/detokenize":
                text = ctx.model.vocab.detokenize(body.get("tokens", []))
                self._json({"content": text})
            elif path == "/apply-template":
                self._json({"prompt": ctx.apply_chat_template(body.get("messages", []))})
            elif path == "/lora-adapters":
                self._not_ported("LoRA adapters")
            elif path == "/infill":
                try:
                    body["prompt"] = ctx.format_infill(body)
                except ValueError as e:
                    self._json({"error": {"message": str(e)}}, 400)
                    return
                self._completion(body, openai=False)
            elif path in ("/rerank", "/reranking", "/v1/rerank", "/v1/reranking"):
                self._not_ported("rerank")
            elif path.startswith("/slots/"):
                try:
                    slot_id = int(path.split("/")[2])
                except (IndexError, ValueError):
                    self._json({"error": {"message": "bad slot id"}}, 400)
                    return
                action = ""
                if "?" in self.path:
                    from urllib.parse import parse_qs

                    action = parse_qs(self.path.split("?", 1)[1]).get("action", [""])[0]
                try:
                    out = ctx.slot_action(slot_id, action, body)
                except NotImplementedError as e:
                    self._json({"error": {"message": str(e)}}, 501)
                    return
                except Exception as e:
                    self._json({"error": {"message": str(e)}}, 400)
                    return
                self._json(out)
            elif path in ("/embedding", "/embeddings", "/v1/embeddings"):
                self._not_ported("embeddings")
            else:
                self._json({"error": "not found"}, 404)

        def _run_task(self, task: Task, on_chunk, on_final):
            ctx.pending.put(task)
            while True:
                try:
                    msg = task.out.get(timeout=600)
                except queue.Empty:
                    task.cancelled = True
                    raise
                if "error" in msg:
                    self._json({"error": {"message": msg["error"]}}, 400)
                    return
                if msg.get("stop"):
                    on_final(msg)
                    return
                on_chunk(msg)

        def _completion(self, body: dict, openai: bool):
            try:
                task = ctx.make_task(body, "completion")
            except NotImplementedError as e:
                self._json({"error": {"message": str(e)}}, 501)
                return
            except Exception as e:
                self._json({"error": {"message": str(e)}}, 400)
                return
            if task.stream:
                self._sse_start()

                def chunk(m):
                    self._sse({"content": m["content"], "stop": False})

                def final(m):
                    self._sse({**m})
                    self.wfile.write(b"data: [DONE]\n\n")

                try:
                    self._run_task(task, chunk, final)
                except (BrokenPipeError, ConnectionResetError):
                    task.cancelled = True
                return
            parts: list[str] = []
            result = {}

            def chunk(m):
                parts.append(m["content"])

            def final(m):
                result.update(m)

            self._run_task(task, chunk, final)
            text = "".join(parts) + result.get("content", "")
            if openai:
                self._json({
                    "id": task.id,
                    "object": "text_completion",
                    "choices": [{
                        "text": text,
                        "index": 0,
                        "finish_reason": "stop"
                        if result.get("stop_reason") == "eos"
                        else "length",
                    }],
                    "usage": {
                        "prompt_tokens": len(task.prompt_ids),
                        "completion_tokens": result.get("tokens_predicted", 0),
                    },
                })
            else:
                self._json({**result, "content": text})

        def _chat(self, body: dict):
            try:
                task = ctx.make_task(body, "chat")
            except NotImplementedError as e:
                self._json({"error": {"message": str(e)}}, 501)
                return
            except Exception as e:
                self._json({"error": {"message": str(e)}}, 400)
                return
            created = int(time.time())
            model_name = ctx.model.config.metadata.get("general.name", "model")
            if task.stream:
                self._sse_start()

                def chunk(m):
                    self._sse({
                        "id": task.id,
                        "object": "chat.completion.chunk",
                        "created": created,
                        "model": model_name,
                        "choices": [{
                            "index": 0,
                            "delta": {"content": m["content"]},
                            "finish_reason": None,
                        }],
                    })

                def final(m):
                    self._sse({
                        "id": task.id,
                        "object": "chat.completion.chunk",
                        "created": created,
                        "model": model_name,
                        "choices": [{
                            "index": 0,
                            "delta": {},
                            "finish_reason": "stop"
                            if m.get("stop_reason") == "eos"
                            else "length",
                        }],
                    })
                    self.wfile.write(b"data: [DONE]\n\n")

                try:
                    self._run_task(task, chunk, final)
                except (BrokenPipeError, ConnectionResetError):
                    task.cancelled = True
                return
            parts: list[str] = []
            result = {}
            self._run_task(task, lambda m: parts.append(m["content"]), result.update)
            text = "".join(parts) + result.get("content", "")
            # reasoning extraction (<think>/<rr>; common/chat-parser.cpp) and
            # tool-call parsing when the request declared tools
            from ..runtime.chat import parse_reasoning, parse_tool_calls

            reasoning_fmt = body.get("reasoning_format", "deepseek")
            text, reasoning = parse_reasoning(text, reasoning_fmt)
            message = {"role": "assistant", "content": text}
            finish = "stop" if result.get("stop_reason") == "eos" else "length"
            if reasoning:
                message["reasoning_content"] = reasoning
            if body.get("tools"):
                parsed = parse_tool_calls(text)
                if parsed.tool_calls:
                    message["content"] = parsed.content or None
                    message["tool_calls"] = [
                        {
                            "id": f"call_{i}",
                            "type": "function",
                            "function": tc,
                        }
                        for i, tc in enumerate(parsed.tool_calls)
                    ]
                    finish = "tool_calls"
            self._json({
                "id": task.id,
                "object": "chat.completion",
                "created": created,
                "model": model_name,
                "choices": [{
                    "index": 0,
                    "message": message,
                    "finish_reason": finish,
                }],
                "usage": {
                    "prompt_tokens": len(task.prompt_ids),
                    "completion_tokens": result.get("tokens_predicted", 0),
                    "total_tokens": len(task.prompt_ids) + result.get("tokens_predicted", 0),
                },
            })

    return Handler



def serve(
    model: Model, host="127.0.0.1", port=8080, n_slots=4, ctx_size=2048, dtype=None,
    loras=None, mesh=None, vision=None, draft_model=None, ctx_shift=True,
    kv_type="dense", spec_ondevice=0, spec_k=4, device=None,
):
    ctx = ServerContext(model, n_slots=n_slots, ctx_size=ctx_size, dtype=dtype,
                        loras=loras, mesh=mesh, vision=vision,
                        draft_model=draft_model, ctx_shift=ctx_shift,
                        kv_type=kv_type, spec_ondevice=spec_ondevice,
                        spec_k=spec_k, device=device)
    ctx.start()
    httpd = ThreadingHTTPServer((host, port), make_handler(ctx))
    return ctx, httpd
