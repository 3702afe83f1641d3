"""Where the time of a decode step (or of a prefill) goes, on the GPU.

    python -m llamacog_tpu_torch.tools.profile [--model mixtral-8x7b] [--layers 32] \
        [--steps 32] [--kv-type q8_0] [--prompt 512 --prefill] [--max-seq 8192] \
        [--ftype IQ3_XXS]

Builds the Llama-3-8B (or, with --model mixtral-8x7b, the Mixtral-8x7B)
synthetic model of the weight preset --ftype (each tensor of the kind
llama.cpp's rules give it, for a codebook preset those of a file made
with an importance matrix, as the public IQ files are; by default
utils/synthetic.py's DEFAULT_LAYOUT, Q4_K_M with every attn_v Q6_K) (depth
cut by --layers) with an Engine of --max-seq
slots (1024 by default) and prefills a --prompt-token prompt (128). Decode
runs --steps greedy steps two ways: replayed from the step's CUDA graph
(Engine.decode_greedy_tokens) and eagerly, the same step function called
from Python every token (Engine.decode_greedy_tokens_eager). Each way is
warmed up (the graph captured), timed on the host clock in turns (graph,
eager, eager, graph), then run once under torch.profiler. Prints per way
host ms/token, device busy ms/token (the sum of kernel times the profiler
saw), the device's idle share of the profiled run, kernel launches and
graph replays a token, and kernel time by name; the host time of the two
pieces the cache kind changes (the step's bulk cache write and one layer's
decode attention call, without a sync); host op time by name for the eager
step. If the profiler sees no CUDA kernels, the device numbers are
reported as not measured. With --prefill the profiled work is one prefill
of the prompt instead (after two warm-up prefills), and the numbers are
per prefill; the environment's routes apply (e.g. LLAMACOG_MMQ=1 for the
int8 prefill).
"""

from __future__ import annotations

import argparse
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="llamacog-profile-torch")
    ap.add_argument("--model", choices=("llama3-8b", "mixtral-8x7b"), default="llama3-8b")
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--prompt", type=int, default=128)
    ap.add_argument("--max-seq", type=int, default=1024)
    ap.add_argument("--kv-type", default="dense", help="KV cache kinds, as Engine's kv_type")
    ap.add_argument("--prefill", action="store_true",
                    help="profile one prefill of the prompt instead of the decode steps")
    ap.add_argument("--ftype", default=None,
                    help="weight preset of the synthetic model (utils/synthetic.py PRESETS; "
                         "DEFAULT_LAYOUT if not given)")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..ops.cuda.flash_q8 import decode_from_cache
    from ..runtime.engine import Engine
    from ..utils.synthetic import (CODEBOOK_PRESETS, DEFAULT_LAYOUT, llama3_8b_config,
                                   make_synthetic_params, mixtral_8x7b_config)

    make_config = mixtral_8x7b_config if args.model == "mixtral-8x7b" else llama3_8b_config
    cfg = make_config(n_layer=args.layers)
    params = make_synthetic_params(cfg, seed=0, ftype=args.ftype or DEFAULT_LAYOUT,
                                   imatrix=args.ftype in CODEBOOK_PRESETS)
    eng = Engine(params, cfg, batch_size=1, max_seq=args.max_seq, kv_type=args.kv_type)
    prompt = [(i * 31337) % cfg.n_vocab for i in range(args.prompt)]

    def prefill() -> int:
        eng.reset()
        return int(eng.prefill(prompt).argmax())  # ends in a device->host copy

    def timed_prefill() -> float:
        eng.reset()
        t0 = time.perf_counter()
        eng.prefill(prompt)  # ends in a device->host copy
        return time.perf_counter() - t0

    def report(prof, wall_prof, per, unit, label) -> None:
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if not kernels:
            print(f"[profile] {label}: device busy time: not measured (the profiler saw no "
                  "CUDA kernels)")
            return
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / per
        launches = sum(e.count for e in kernels) / per
        replays = sum(e.count for e in prof.key_averages() if e.key == "cudaGraphLaunch") / per
        print(f"[profile] {label}: device busy {busy_ms:.3f} ms/{unit} over {launches:.0f} "
              f"kernel launches/{unit}, {replays:.2f} graph replays/{unit}; idle share "
              f"{1 - busy_ms / (wall_prof / per * 1e3):.3f} of the profiled {unit} "
              f"({wall_prof / per * 1e3:.3f} ms/{unit} under the profiler)")
        print(f"{'kernel (' + label + ')':<70} {'calls':>9} {'ms/' + unit:>11} {'avg us':>8}")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:25]:
            print(f"{e.key[:70]:<70} {e.count / per:>9.1f} "
                  f"{e.self_device_time_total / 1e3 / per:>11.4f} "
                  f"{e.self_device_time_total / max(e.count, 1):>8.2f}")

    def host_ops(prof, per, unit) -> None:
        """Where the host's time goes (the profiler's own cost is in every row)."""
        host = [e for e in prof.key_averages() if e.self_cpu_time_total > 0]
        print(f"{'host op (self CPU time)':<70} {'calls':>9} {'ms/' + unit:>11} {'avg us':>8}")
        for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:15]:
            print(f"{e.key[:70]:<70} {e.count / per:>9.1f} "
                  f"{e.self_cpu_time_total / 1e3 / per:>11.4f} "
                  f"{e.self_cpu_time_total / max(e.count, 1):>8.2f}")

    head = (f"[profile] {torch.cuda.get_device_name(0)}, {args.model}, {args.layers} layers, "
            f"kv {args.kv_type}, a {args.prompt}-token prompt")
    if args.prefill:
        timed_prefill(), timed_prefill()  # warm-up
        wall = timed_prefill()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall_prof = timed_prefill()
        print(f"{head}: one prefill")
        print(f"[profile] host clock: {wall * 1e3:.3f} ms/prefill")
        report(prof, wall_prof, 1, "prefill", "prefill")
        host_ops(prof, 1, "prefill")
        return 0

    ways = {"graph": eng.decode_greedy_tokens, "eager": eng.decode_greedy_tokens_eager}

    def decode(way: str) -> float:
        first = prefill()
        t0 = time.perf_counter()
        ways[way]([first], args.steps)  # ends in a device->host copy
        return time.perf_counter() - t0

    for way in ways:
        decode(way)  # warm-up; the graph way captures the step
    walls = {way: [] for way in ways}
    for way in ("graph", "eager", "eager", "graph"):
        walls[way].append(decode(way) / args.steps * 1e3)
    print(f"{head}: {args.steps} decode steps after the prompt")
    print("[profile] host clock, ms/token (in turns): "
          + "; ".join(f"{way} {', '.join(f'{t:.3f}' for t in ts)}" for way, ts in walls.items()))
    profs = {}
    for way in ways:
        first = prefill()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            ways[way]([first], args.steps)
            wall_prof = time.perf_counter() - t0
        profs[way] = prof
        report(prof, wall_prof, args.steps, "token", way)

    def host_us(fn, n=320) -> float:
        """Host time of one call, the device's drain excluded."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        dt = time.perf_counter() - t0
        torch.cuda.synchronize()
        return dt / n * 1e6

    L, H, Hkv, D = cfg.n_layer, cfg.n_head, cfg.n_head_kv, cfg.head_dim_k
    dev = eng.device
    kv_new = torch.zeros((L, 1, 1, Hkv, D), dtype=eng.dtype, device=dev)
    q, cur = (torch.zeros((1, h, D), dtype=eng.dtype, device=dev) for h in (H, Hkv))
    pos = torch.tensor([args.prompt], dtype=torch.int32, device=dev)
    write_us = host_us(lambda: eng.cache.write_all(kv_new, kv_new, pos))
    attn_us = host_us(lambda: decode_from_cache(q, eng.cache, 0, cur, cur, pos, D**-0.5))
    print(f"[profile] eager host time: cache write_all {write_us:.1f} us a step, "
          f"decode attention call {attn_us:.1f} us a layer")
    host_ops(profs["eager"], args.steps, "token")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
