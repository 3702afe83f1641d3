"""llamacog-cli (PyTorch port) — greedy generation from a llama GGUF.

Usage:
    python -m llamacog_tpu_torch.tools.cli -m model.gguf -p "..." -n 64 \
        [-ctk q8_0 [-ctv q4_0]]

Counterpart of llamacog_tpu/tools/cli.py's plain generation path. Chat,
sampling, speculative decoding and session state stay in the JAX CLI for
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
                                description="greedy llama generation on an NVIDIA GPU")
    p.add_argument("-m", "--model", required=True, help="GGUF model path")
    p.add_argument("-p", "--prompt", default="", help="prompt text")
    p.add_argument("-n", "--n-predict", type=int, default=64, help="tokens to generate")
    p.add_argument("-c", "--ctx-size", type=int, default=2048)
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
    sys.stdout.write(args.prompt)
    sys.stdout.flush()
    eog = [t for t in range(model.config.n_vocab) if vocab.is_eog(t)]
    t1 = time.time()
    logits = engine.prefill(ids)
    t_prefill = time.time() - t1
    t2 = time.time()
    out = [int(logits.argmax())]
    n = min(args.n_predict, args.ctx_size - len(ids)) - 1
    if n > 0 and out[0] not in eog:
        out += [int(t) for t in engine.decode_greedy_tokens([out[0]], n)[0]]
    t_gen = time.time() - t2
    for tok in out:
        if tok in eog:
            break
        sys.stdout.write(vocab.token_to_piece(tok).decode("utf-8", errors="replace"))
    sys.stdout.write("\n")
    print(f"[perf] prompt: {len(ids)} tok in {t_prefill:.3f}s | decode: {len(out) - 1} tok "
          f"in {t_gen:.3f}s | load {t_load:.2f}s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
