"""python -m llamacog_tpu_torch.server -m model.gguf [--port 8080] [--device cpu]
    [-md draft.gguf | --spec-ondevice N [-md draft.gguf] [--spec-k 4] -np 1]

The PyTorch port's server (server.py) on the GPU, or on the CPU (the plain
PyTorch path) when --device cpu is given. -md loads a draft model on the
same device for per-slot speculative decoding; --spec-ondevice N runs the
greedy draft + verify rounds on the device, the draft being -md or the
target's first N layers. The flags of the JAX package's server that this
port does not carry yet (LoRA, control vectors, mmproj, tensor and data
parallelism, metadata overrides, the dequantized mode, the multi-host
mirror) are refused by name.
"""

import argparse
import sys

KV_TYPES = ("f16", "bf16", "q8_0", "q4_0", "q4_1", "q5_0", "q5_1")
# the JAX server's flags this port refuses, with what each would need
NOT_PORTED = {
    "--override-kv": "GGUF metadata overrides (--override-kv)",
    "--mode": "the dequantized weight mode (--mode)",
    "--tensor-parallel": "tensor parallelism (-tp)",
    "--data-parallel": "data parallelism (-dp)",
    "--lora": "LoRA adapters (--lora)",
    "--control-vector": "control vectors (--control-vector)",
    "--control-vector-scale": "control vectors (--control-vector-scale)",
    "--mmproj": "multimodal input (--mmproj)",
    "--coordinator": "the multi-host mirror (--coordinator)",
    "--num-hosts": "the multi-host mirror (--num-hosts)",
    "--host-id": "the multi-host mirror (--host-id)",
}
_SHORT = {"--tensor-parallel": "-tp", "--data-parallel": "-dp"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="llamacog-server-torch")
    p.add_argument("-m", "--model", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("-c", "--ctx-size", type=int, default=2048)
    p.add_argument("-np", "--n-slots", type=int, default=4)
    p.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda (the kernels) or cpu (the plain PyTorch path)")
    p.add_argument("--no-context-shift", action="store_true",
                   help="finish a slot when its context fills instead of shifting")
    p.add_argument("-ctk", "--cache-type-k", choices=KV_TYPES, default="bf16",
                   help="K cache type (q8_0 about halves the KV memory, q4_0 about a third)")
    p.add_argument("-ctv", "--cache-type-v", choices=KV_TYPES, default=None,
                   help="V cache type (defaults to the K type)")
    p.add_argument("-md", "--model-draft", default=None,
                   help="draft model GGUF for per-slot speculative decoding")
    p.add_argument("--spec-ondevice", type=int, default=0, metavar="N",
                   help="on-device speculative decoding (draft + verify rounds as CUDA "
                   "graphs; greedy requests only, requires -np 1). Draft = -md model if "
                   "given, else the target's first N layers")
    p.add_argument("--spec-k", type=int, default=4,
                   help="draft tokens per on-device speculative round")
    for flag in NOT_PORTED:
        names = (_SHORT[flag], flag) if flag in _SHORT else (flag,)
        p.add_argument(*names, action="append", default=None, help=argparse.SUPPRESS)
    return p


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    for flag, what in NOT_PORTED.items():
        if getattr(args, flag[2:].replace("-", "_")) is not None:
            p.error(f"{what} is not ported yet")
    import torch

    from ..models.loader import load_model
    from ..tools.cli import _kv_type_arg
    from .server import serve

    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    model = load_model(args.model, dtype=dtype, device=args.device)
    draft_model = None
    if args.model_draft:
        draft_model = load_model(args.model_draft, dtype=dtype, device=args.device)
    ctx, httpd = serve(
        model, host=args.host, port=args.port, n_slots=args.n_slots,
        ctx_size=args.ctx_size, dtype=dtype, draft_model=draft_model,
        ctx_shift=not args.no_context_shift,
        kv_type=_kv_type_arg(args.cache_type_k, args.cache_type_v),
        spec_ondevice=args.spec_ondevice, spec_k=args.spec_k, device=args.device,
    )
    print(f"llamacog-server (PyTorch port) listening on http://{args.host}:{args.port} "
          f"({args.n_slots} slots, ctx {args.ctx_size}, {args.device})", file=sys.stderr)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        ctx.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
