"""llamacog-cli (PyTorch port) — generation from a llama GGUF.

Usage:
    python -m llamacog_tpu_torch.tools.cli -m model.gguf -p "..." -n 64 \
        [--temp 0.8 --top-k 40 --top-p 0.95 --min-p 0.05 --seed -1 | --greedy] \
        [-ctk q8_0 [-ctv q4_0]]

Counterpart of llamacog_tpu/tools/cli.py's plain generation path, with its
sampling flags and defaults: each token is drawn by the sampler chain from
the logits of one decode step (Engine.decode_one, a replay of the step's
CUDA graph on the GPU); --greedy is temperature 0. Chat, grammars,
speculative decoding, context shift and session state stay in the JAX CLI
for now: generation stops when the context (--ctx-size) is full. Runs on
the GPU unless --device cpu is given.
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
    p.add_argument("-m", "--model", required=True, help="GGUF model path")
    p.add_argument("-p", "--prompt", default="", help="prompt text")
    p.add_argument("-n", "--n-predict", type=int, default=64, help="tokens to generate")
    p.add_argument("-c", "--ctx-size", type=int, default=2048)
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


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import torch

    from ..models.loader import load_model
    from ..runtime.engine import Engine
    from ..runtime.sampler import SamplerChain, SamplerParams

    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    t0 = time.time()
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
    tok = sampler.sample(logits)
    for _ in range(args.n_predict if args.n_predict >= 0 else 1 << 30):
        sampler.accept(tok)
        if vocab.is_eog(tok):
            break
        sys.stdout.write(vocab.token_to_piece(tok).decode("utf-8", errors="replace"))
        sys.stdout.flush()
        if int(engine.seq_len[0]) + 1 >= args.ctx_size:
            break
        tok = sampler.sample(engine.decode_one([tok])[0])
    t_gen = time.time() - t2
    sys.stdout.write("\n")
    print(f"[perf] prompt: {len(ids)} tok in {t_prefill:.3f}s | decode: {int(engine.seq_len[0]) - len(ids)} tok "
          f"in {t_gen:.3f}s | load {t_load:.2f}s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
