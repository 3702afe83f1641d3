"""llamacog-cli (PyTorch port) — generation from a GGUF of any architecture
the port's forward takes (models/llama.py::SUPPORTED_ARCHES: the llama,
Qwen, Gemma, layer-norm, ALiBi and other families, and the MoE variants
deepseek, dots1, bailingmoe, phimoe, grok, arctic and dbrx).

Usage:
    python -m llamacog_tpu_torch.tools.cli -m model.gguf -p "..." -n 64 \
        [--temp 0.8 --top-k 40 --top-p 0.95 --min-p 0.05 --seed -1 | --greedy] \
        [-ctk q8_0 [-ctv q4_0]] [--keep N] [-f prompt.txt] [--no-display-prompt]
    python -m llamacog_tpu_torch.tools.cli -m model.gguf -cnv [-sys "..."] \
        [--chat-template chatml] [-r "User:"] [--prompt-cache session.npz]
    python -m llamacog_tpu_torch.tools.cli -m model.gguf --greedy \
        --spec-ondevice 4 [-md draft.gguf] [--spec-k 4]
    python -m llamacog_tpu_torch.tools.cli -m synthetic:gemma3-12b ...

``-m synthetic:NAME`` runs the random-weight Q4_K_M model of a published
configuration instead of a file (utils/synthetic.py CONFIGS: llama3-8b,
llama3.2-1b, qwen2.5-7b, qwen3-30b-a3b, gemma3-12b, bloom-7b1, jais-13b,
deepseek-moe-16b, dots1, ling-lite, phi3.5-moe, grok-1, dbrx, arctic, ...)
at its published depth (Grok-1, DBRX and Arctic do not fit on one card at
it), with a synthetic SPM vocab of its size.

Counterpart of llamacog_tpu/tools/cli.py, with its sampling flags and
defaults: each token is drawn by the sampler chain from the logits of one
decode step (Engine.decode_one, a replay of the step's CUDA graph on the
GPU); --greedy is temperature 0. When the context (--ctx-size) is full,
half of the tokens past the first --keep are dropped and generation goes
on (Engine.shift_row, as the JAX CLI does); the -ctk kinds name a
full-store cache, never the sliding-window ring, so a Gemma model shifts
as well. -i / -cnv read more input after each reply (-cnv wraps each turn
in the model's chat template, or --chat-template's builtin one, after the
-sys system prompt; -r stops a reply at a string); a turn prefills only
what its prompt does not share with the tokens already in the cache.
--prompt-cache restores the cache and its tokens from a state file
(runtime/state.py, the JAX package's format) and saves them on exit.
--spec-ondevice N decodes greedy tokens through OnDeviceSpeculative
(runtime/speculative.py: draft and verify rounds on the device, in chunks
of 16 tokens), the draft being -md's model or the target's first N
layers; with sampling it is ignored with a warning, as in the JAX CLI.
Grammars stay in the server. Runs on the GPU unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

KV_TYPES = ("f16", "bf16", "q8_0", "q4_0", "q4_1", "q5_0", "q5_1")


def _kv_type_arg(ctk: str, ctv: str | None) -> str:
    """-ctk/-ctv flag values -> Engine kv_type ("k:v" when they differ);
    make_cache resolves dense kinds and picks the cache class."""
    ctv = ctv or ctk
    return ctk if ctk == ctv else f"{ctk}:{ctv}"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="llamacog-cli-torch",
                                description="llama generation on an NVIDIA GPU")
    p.add_argument("-m", "--model", required=True,
                   help="GGUF model path, or synthetic:NAME (utils/synthetic.py CONFIGS)")
    p.add_argument("-p", "--prompt", default="", help="prompt text")
    p.add_argument("-n", "--n-predict", type=int, default=64, help="tokens to generate")
    p.add_argument("-c", "--ctx-size", type=int, default=2048)
    p.add_argument("--keep", type=int, default=0,
                   help="tokens kept from the initial prompt on context shift")
    p.add_argument("--temp", type=float, default=0.8)
    p.add_argument("--top-k", type=int, default=40)
    p.add_argument("--top-p", type=float, default=0.95)
    p.add_argument("--min-p", type=float, default=0.05)
    p.add_argument("--seed", type=int, default=-1)
    p.add_argument("--greedy", action="store_true", help="greedy decoding (temp 0)")
    p.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    p.add_argument("-ctk", "--cache-type-k", choices=KV_TYPES, default="bf16",
                   help="K cache type (q8_0 about halves the KV memory, q4_0 about a third)")
    p.add_argument("-ctv", "--cache-type-v", choices=KV_TYPES, default=None,
                   help="V cache type (defaults to the K type)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda (the kernels) or cpu (the plain PyTorch path)")
    p.add_argument("-f", "--file", default=None, help="prompt from file")
    p.add_argument("-i", "--interactive", action="store_true",
                   help="interactive mode (read more input after each reply)")
    p.add_argument("-cnv", "--conversation", action="store_true",
                   help="chat mode: wrap turns with the model's chat template")
    p.add_argument("--chat-template", default=None,
                   help="builtin chat template name (overrides the GGUF's)")
    p.add_argument("-r", "--reverse-prompt", action="append", default=[],
                   help="stop generating and return control at this string")
    p.add_argument("-sys", "--system-prompt", default=None, help="chat system prompt")
    p.add_argument("--prompt-cache", default=None,
                   help="session file: restore the matching prompt prefix, save on exit "
                        "(tools/main/main.cpp:236-254)")
    p.add_argument("-md", "--model-draft", default=None,
                   help="draft model GGUF for --spec-ondevice")
    p.add_argument("--spec-ondevice", type=int, default=0, metavar="N",
                   help="on-device speculative decoding (draft + verify rounds as CUDA "
                   "graphs; greedy only). Draft = -md model if given, else the target's "
                   "first N layers")
    p.add_argument("--spec-k", type=int, default=4,
                   help="draft tokens per on-device speculative round")
    p.add_argument("--no-display-prompt", action="store_true")
    p.add_argument("--verbose", "-v", action="store_true")
    return p


def synthetic_model(name: str, device: str):
    """The Q4_K_M random-weight model of the configuration `name`, with a
    synthetic SPM vocab of its size and that vocab's tokenizer."""
    from ..models.loader import Model
    from ..tokenizer import build_tokenizer
    from ..utils.synthetic import CONFIGS, make_synthetic_params, synthetic_vocab

    if name not in CONFIGS:
        raise SystemExit(f"error: unknown synthetic model {name!r} (one of "
                         f"{', '.join(CONFIGS)})")
    cfg = CONFIGS[name]()
    vocab = synthetic_vocab(cfg.n_vocab)
    return Model(cfg, make_synthetic_params(cfg, seed=0, device=device, ftype="Q4_K_M"), vocab,
                 build_tokenizer(vocab))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import numpy as np
    import torch

    from ..models.loader import load_model
    from ..runtime.engine import Engine
    from ..runtime.sampler import SamplerChain, SamplerParams

    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    t0 = time.time()
    if args.model.startswith("synthetic:"):
        model = synthetic_model(args.model.split(":", 1)[1], args.device)
    else:
        model = load_model(args.model, dtype=dtype, device=args.device)
    t_load = time.time() - t0
    if args.verbose:
        print(f"[load] {t_load * 1000:.0f} ms | arch={model.config.arch} "
              f"layers={model.config.n_layer} embd={model.config.n_embd}", file=sys.stderr)
    tok = model.tokenizer
    if tok is None:
        print("error: model has no supported tokenizer", file=sys.stderr)
        return 1
    vocab = model.vocab
    engine = Engine(model.params, model.config, max_seq=args.ctx_size, dtype=dtype,
                    kv_type=_kv_type_arg(args.cache_type_k, args.cache_type_v),
                    device=args.device)

    spec = draft_engine = None
    if args.spec_ondevice:
        if not (args.greedy or args.temp <= 0.0):
            print("warning: --spec-ondevice is greedy-exact only; ignoring it for sampled "
                  "decoding (set --greedy)", file=sys.stderr)
        else:
            from dataclasses import replace

            from ..runtime.speculative import OnDeviceSpeculative, truncated_draft_params

            if args.model_draft:
                dm = load_model(args.model_draft, dtype=dtype, device=args.device)
                d_params, d_cfg = dm.params, dm.config
            else:
                d_params = truncated_draft_params(model.params, args.spec_ondevice)
                d_cfg = replace(model.config, n_layer=args.spec_ondevice)
            # a dense store in the compute dtype: never the sliding-window ring
            draft_engine = Engine(d_params, d_cfg, max_seq=args.ctx_size, dtype=dtype,
                                  kv_type="bf16", device=args.device)
            spec = OnDeviceSpeculative(engine, draft_engine, k=args.spec_k)

    sampler = SamplerChain(SamplerParams(temp=0.0 if args.greedy else args.temp,
                                         top_k=args.top_k, top_p=args.top_p,
                                         min_p=args.min_p, seed=args.seed),
                           n_vocab=model.config.n_vocab)
    prompt_text = args.prompt
    if args.file:
        with open(args.file, encoding="utf-8") as f:
            prompt_text = f.read()

    messages = []
    if args.conversation and args.system_prompt:
        messages.append({"role": "system", "content": args.system_prompt})

    def render_chat(user_text: str) -> str:
        from ..runtime.chat import apply_builtin_template, render_template

        messages.append({"role": "user", "content": user_text})
        if args.chat_template:
            return apply_builtin_template(args.chat_template, messages, True)
        return render_template(
            vocab.chat_template if vocab else None, messages, add_generation_prompt=True,
            bos_token=vocab.tokens[vocab.bos_id] if vocab and vocab.bos_id >= 0 else "",
            eos_token=vocab.tokens[vocab.eos_id] if vocab and vocab.eos_id >= 0 else "",
        )

    history: list[int] = []  # the tokens in the KV row

    # prompt-cache restore (reference tools/main/main.cpp:236-254)
    if args.prompt_cache and os.path.exists(args.prompt_cache):
        from ..runtime.state import load_row_state

        try:
            history = load_row_state(engine, args.prompt_cache)
            if args.verbose:
                print(f"[cache] restored {len(history)} tokens", file=sys.stderr)
        except Exception as e:
            print(f"[cache] ignoring invalid session file: {e}", file=sys.stderr)
            history = []

    def feed(ids: list[int]):
        """Prefill ids, reusing the cached common prefix; returns the last
        logits and the tokens fed."""
        nonlocal history
        n_common = 0
        limit = min(len(history), len(ids) - 1)
        while n_common < limit and history[n_common] == ids[n_common]:
            n_common += 1
        engine.seq_len[0] = n_common
        logits = engine.prefill(ids[n_common:])
        if draft_engine is not None:  # the draft row stays in lockstep
            draft_engine.seq_len[0] = n_common
            draft_engine.prefill(ids[n_common:])
        history = list(ids)
        return logits, len(ids) - n_common

    spec_totals = {"drafted": 0, "accepted": 0, "rounds": 0}

    def generate(logits) -> tuple[str, int]:
        """Stream tokens until EOG, the limit or a reverse prompt; returns
        (text, tokens generated)."""
        nonlocal history
        text, n_gen = "", 0
        tok_id = sampler.sample(logits)
        pending: list[int] = []  # speculation: tokens decoded ahead on the device
        limit = args.n_predict if args.n_predict >= 0 else 1 << 30
        for _ in range(limit):
            piece = vocab.token_to_piece(tok_id).decode("utf-8", errors="replace")
            sampler.accept(tok_id)
            history.append(tok_id)
            n_gen += 1
            if vocab.is_eog(tok_id):
                break
            sys.stdout.write(piece)
            sys.stdout.flush()
            text += piece
            if any(text.endswith(r) for r in args.reverse_prompt):
                break
            if int(engine.seq_len[0]) + 1 >= args.ctx_size:
                # context shift: drop the oldest half beyond --keep
                # (tools/main/main.cpp; the engine re-rotates the moved K)
                n_keep = args.keep
                n_discard = (int(engine.seq_len[0]) - n_keep) // 2
                engine.shift_row(0, n_keep, n_discard)
                if draft_engine is not None:
                    draft_engine.shift_row(0, n_keep, n_discard)
                    pending = []  # positions moved; decode them again
                history = history[:n_keep] + history[n_keep + n_discard:]
                if args.verbose:
                    print(f"\n[ctx shift] discarded {n_discard}", file=sys.stderr)
            if spec is not None:
                if not pending:
                    room = args.ctx_size - int(engine.seq_len[0]) - spec.k - 2
                    if room >= 2:
                        n = max(1, min(16, limit - n_gen + 1, room))
                        pre_t, pre_d = int(engine.seq_len[0]), int(draft_engine.seq_len[0])
                        toks, st = spec.generate_greedy(tok_id, n)
                        # rewind the overshoot of the last round (whole rounds
                        # run) so that the next input lands at its slot
                        engine.seq_len[0] = pre_t + n
                        draft_engine.seq_len[0] = pre_d + n
                        for key in ("drafted", "accepted", "rounds"):
                            spec_totals[key] += st[key]
                        pending = [int(t) for t in toks]
                    else:
                        logits = engine.decode_one(np.array([tok_id]))[0]
                        draft_engine.decode_one(np.array([tok_id]))
                        pending = [int(np.argmax(logits))]
                tok_id = pending.pop(0)
                continue
            tok_id = sampler.sample(engine.decode_one([tok_id])[0])
        return text, n_gen

    interactive = args.interactive or args.conversation
    first_input = prompt_text
    total_gen, t_gen_total = 0, 0.0
    t_prefill, n_prompt = 0.0, 0
    while True:
        if not first_input and interactive:
            try:
                sys.stdout.write("\n> ")
                sys.stdout.flush()
                first_input = input()
            except EOFError:
                break
            if not first_input.strip():
                continue
        if args.conversation:
            text_in = render_chat(first_input)
        else:
            text_in = first_input
            if not args.no_display_prompt:
                sys.stdout.write(text_in)
                sys.stdout.flush()
        ids = tok.tokenize(text_in, add_special=not args.conversation, parse_special=True)
        if args.conversation and vocab.add_bos and vocab.bos_id >= 0:
            if not ids or ids[0] != vocab.bos_id:
                ids = [vocab.bos_id] + ids
        if not ids:
            # an empty or untokenizable prompt: seed with BOS so the engine
            # has one real token, as llama-cli does
            if vocab.bos_id < 0:
                print("error: prompt tokenized to zero tokens and the vocab has no BOS",
                      file=sys.stderr)
                return 1
            ids = [vocab.bos_id]
        t1 = time.time()
        logits, n_fed = feed(ids)
        t_prefill += time.time() - t1
        n_prompt += n_fed
        t2 = time.time()
        text, n_gen = generate(logits)
        t_gen_total += time.time() - t2
        total_gen += n_gen
        if args.conversation:
            messages.append({"role": "assistant", "content": text})
        first_input = ""
        if not interactive:
            break
    sys.stdout.write("\n")

    if args.prompt_cache:
        from ..runtime.state import save_row_state

        save_row_state(engine, args.prompt_cache, tokens=history)
        if args.verbose:
            print(f"[cache] saved {len(history)} tokens", file=sys.stderr)
    pp_tps = n_prompt / t_prefill if t_prefill > 0 else 0.0
    tg_tps = total_gen / t_gen_total if t_gen_total > 0 else 0.0
    print(f"[perf] prompt: {n_prompt} tok in {t_prefill:.3f}s, {pp_tps:.2f} t/s | decode: "
          f"{total_gen} tok in {t_gen_total:.3f}s, {tg_tps:.2f} t/s | load {t_load:.2f}s",
          file=sys.stderr)
    if spec is not None and spec_totals["drafted"]:
        print(f"[spec] drafted {spec_totals['drafted']}, accepted {spec_totals['accepted']} "
              f"({spec_totals['accepted'] / spec_totals['drafted']:.0%}) over "
              f"{spec_totals['rounds']} rounds", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
