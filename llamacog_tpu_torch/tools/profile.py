"""Where the time of a decode step goes, on the GPU.

    python -m llamacog_tpu_torch.tools.profile [--layers 32] [--steps 32]

Builds the Llama-3-8B synthetic Q4_K_M model (depth cut by --layers),
prefills a 128-token prompt, then runs --steps greedy decode steps
(Engine.decode_greedy_tokens) twice: once timed on the host clock, once
under torch.profiler. Prints host ms/token, device busy ms/token (the sum
of kernel times the profiler saw), the device's idle share, and kernel
time by name. If the profiler sees no CUDA kernels, the device numbers are
reported as not measured.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="llamacog-profile-torch")
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--prompt", type=int, default=128)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..runtime.engine import Engine
    from ..utils.synthetic import llama3_8b_config, make_synthetic_params

    cfg = llama3_8b_config(n_layer=args.layers)
    eng = Engine(make_synthetic_params(cfg, seed=0), cfg, batch_size=1, max_seq=1024)
    prompt = [(i * 31337) % cfg.n_vocab for i in range(args.prompt)]

    def prefill() -> int:
        eng.reset()
        return int(eng.prefill(prompt).argmax())  # ends in a device->host copy

    def decode(first: int) -> float:
        t0 = time.perf_counter()
        eng.decode_greedy_tokens([first], args.steps)  # ends in a device->host copy
        return time.perf_counter() - t0

    decode(prefill())  # warm-up
    wall = decode(prefill())
    first = prefill()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_prof = decode(first)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / args.steps
    print(f"[profile] {torch.cuda.get_device_name(0)}, {args.layers} layers, "
          f"{args.steps} decode steps after a {args.prompt}-token prompt")
    print(f"[profile] host clock: {wall / args.steps * 1e3:.3f} ms/token "
          f"({args.steps / wall:.2f} tokens/s); under the profiler "
          f"{wall_prof / args.steps * 1e3:.3f} ms/token")
    if not kernels:
        print("[profile] device busy time: not measured (the profiler saw no CUDA kernels)")
        return 0
    launches = sum(e.count for e in kernels) / args.steps
    print(f"[profile] device busy {busy_ms:.3f} ms/token over {launches:.0f} kernel "
          f"launches/token; idle share {1 - busy_ms / (wall_prof / args.steps * 1e3):.3f} "
          f"of the profiled step")
    print(f"{'kernel':<70} {'calls/tok':>9} {'ms/tok':>8} {'avg us':>8}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:25]:
        print(f"{e.key[:70]:<70} {e.count / args.steps:>9.1f} "
              f"{e.self_device_time_total / 1e3 / args.steps:>8.4f} "
              f"{e.self_device_time_total / max(e.count, 1):>8.2f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
