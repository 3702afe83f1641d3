"""llamacog-cli (PyTorch port) — generation from a GGUF of any architecture
the port's forward takes (models/llama.py::SUPPORTED_ARCHES: the llama,
Qwen, Gemma, layer-norm, ALiBi and other families, and the MoE variants
deepseek, dots1, bailingmoe, phimoe, grok, arctic and dbrx).

Usage:
    python -m llamacog_tpu_torch.tools.cli -m model.gguf -p "..." -n 64 \
        [--temp 0.8 --top-k 40 --top-p 0.95 --min-p 0.05 --seed -1 | --greedy] \
        [-ctk q8_0 [-ctv q4_0]] [--keep N]
    python -m llamacog_tpu_torch.tools.cli -m synthetic:gemma3-12b ...

``-m synthetic:NAME`` runs the random-weight Q4_K_M model of a published
configuration instead of a file (utils/synthetic.py CONFIGS: llama3-8b,
qwen2.5-7b, qwen3-30b-a3b, gemma3-12b, bloom-7b1, jais-13b, deepseek-moe-16b,
dots1, ling-lite, phi3.5-moe, grok-1, dbrx, arctic, ...) at its published
depth (Grok-1, DBRX and Arctic do not fit on one card at it), with a
synthetic SPM vocab of its size.

Counterpart of llamacog_tpu/tools/cli.py's plain generation path, with its
sampling flags and defaults: each token is drawn by the sampler chain from
the logits of one decode step (Engine.decode_one, a replay of the step's
CUDA graph on the GPU); --greedy is temperature 0. When the context
(--ctx-size) is full, half of the tokens past the first --keep are dropped
and generation goes on (Engine.shift_row, as the JAX CLI does); the
-ctk kinds name a full-store cache, never the sliding-window ring, so a
Gemma model shifts as well. Chat,
grammars, speculative decoding and session state stay in the JAX CLI for
now. Runs on the GPU unless --device cpu is given.
"""

from __future__ import annotations

import argparse
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
    if model.tokenizer is None:
        print("error: model has no supported tokenizer", file=sys.stderr)
        return 1
    engine = Engine(model.params, model.config, max_seq=args.ctx_size, dtype=dtype,
                    kv_type=_kv_type_arg(args.cache_type_k, args.cache_type_v),
                    device=args.device)
    vocab = model.vocab
    ids = model.tokenizer.tokenize(args.prompt, add_special=True, parse_special=True)
    if not ids:
        if vocab.bos_id < 0:
            print("error: prompt tokenized to zero tokens and the vocab has no BOS",
                  file=sys.stderr)
            return 1
        ids = [vocab.bos_id]
    sampler = SamplerChain(SamplerParams(temp=0.0 if args.greedy else args.temp,
                                         top_k=args.top_k, top_p=args.top_p,
                                         min_p=args.min_p, seed=args.seed),
                           n_vocab=model.config.n_vocab)
    sys.stdout.write(args.prompt)
    sys.stdout.flush()
    t1 = time.time()
    logits = engine.prefill(ids)
    t_prefill = time.time() - t1
    t2 = time.time()
    n_gen = 0
    tok = sampler.sample(logits)
    for _ in range(args.n_predict if args.n_predict >= 0 else 1 << 30):
        sampler.accept(tok)
        if vocab.is_eog(tok):
            break
        sys.stdout.write(vocab.token_to_piece(tok).decode("utf-8", errors="replace"))
        sys.stdout.flush()
        if int(engine.seq_len[0]) + 1 >= args.ctx_size:
            # context shift: drop the oldest half beyond --keep
            # (tools/main/main.cpp; the engine re-rotates the moved K)
            engine.shift_row(0, args.keep, (int(engine.seq_len[0]) - args.keep) // 2)
        tok = sampler.sample(engine.decode_one([tok])[0])
        n_gen += 1
    t_gen = time.time() - t2
    sys.stdout.write("\n")
    print(f"[perf] prompt: {len(ids)} tok in {t_prefill:.3f}s | decode: {n_gen} tok "
          f"in {t_gen:.3f}s | load {t_load:.2f}s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
