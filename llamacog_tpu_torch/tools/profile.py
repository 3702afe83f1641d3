"""Where the time of a decode step (or of a prefill) goes, on the GPU.

    python -m llamacog_tpu_torch.tools.profile [--model mixtral-8x7b] [--layers 32] \
        [--steps 32] [--kv-type q8_0] [--prompt 512 --prefill]

Builds the Llama-3-8B (or, with --model mixtral-8x7b, the Mixtral-8x7B)
synthetic Q4_K_M model (depth cut by --layers),
prefills a 128-token prompt, then runs --steps greedy decode steps
(Engine.decode_greedy_tokens) twice: once timed on the host clock, once
under torch.profiler. Prints host ms/token, the host time of the two
pieces the cache kind changes (the step's bulk cache write and one layer's
decode attention call, without a sync), device busy ms/token (the sum of
kernel times the profiler saw), the device's idle share, kernel time by
name and host op time by name. If the profiler sees no CUDA kernels, the
device numbers are reported as not measured. With --prefill the profiled
work is one prefill of the prompt instead (after two warm-up prefills),
and the numbers are per prefill; the environment's routes apply (e.g.
LLAMACOG_MMQ=1 for the int8 prefill).
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
    ap.add_argument("--kv-type", default="dense", help="KV cache kinds, as Engine's kv_type")
    ap.add_argument("--prefill", action="store_true",
                    help="profile one prefill of the prompt instead of the decode steps")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..ops.cuda.flash_q8 import decode_from_cache
    from ..runtime.engine import Engine
    from ..utils.synthetic import llama3_8b_config, make_synthetic_params, mixtral_8x7b_config

    make_config = mixtral_8x7b_config if args.model == "mixtral-8x7b" else llama3_8b_config
    cfg = make_config(n_layer=args.layers)
    eng = Engine(make_synthetic_params(cfg, seed=0), cfg, batch_size=1, max_seq=1024,
                 kv_type=args.kv_type)
    prompt = [(i * 31337) % cfg.n_vocab for i in range(args.prompt)]

    def prefill() -> int:
        eng.reset()
        return int(eng.prefill(prompt).argmax())  # ends in a device->host copy

    def decode(first: int) -> float:
        t0 = time.perf_counter()
        eng.decode_greedy_tokens([first], args.steps)  # ends in a device->host copy
        return time.perf_counter() - t0

    def timed_prefill() -> float:
        eng.reset()
        t0 = time.perf_counter()
        eng.prefill(prompt)  # ends in a device->host copy
        return time.perf_counter() - t0

    if args.prefill:
        per, unit = 1, "prefill"
        timed_prefill(), timed_prefill()  # warm-up
        wall = timed_prefill()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall_prof = timed_prefill()
    else:
        per, unit = args.steps, "token"
        decode(prefill())  # warm-up
        wall = decode(prefill())
        first = prefill()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall_prof = decode(first)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / per
    what = "one prefill of" if args.prefill else f"{args.steps} decode steps after"
    print(f"[profile] {torch.cuda.get_device_name(0)}, {args.model}, {args.layers} layers, "
          f"{what} a {args.prompt}-token prompt, kv {args.kv_type}")
    print(f"[profile] host clock: {wall / per * 1e3:.3f} ms/{unit}; under the profiler "
          f"{wall_prof / per * 1e3:.3f} ms/{unit}")

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

    if not args.prefill:
        L, H, Hkv, D = cfg.n_layer, cfg.n_head, cfg.n_head_kv, cfg.head_dim_k
        dev = eng.device
        kv_new = torch.zeros((L, 1, 1, Hkv, D), dtype=eng.dtype, device=dev)
        q, cur = (torch.zeros((1, h, D), dtype=eng.dtype, device=dev) for h in (H, Hkv))
        pos = torch.tensor([args.prompt], dtype=torch.int32, device=dev)
        write_us = host_us(lambda: eng.cache.write_all(kv_new, kv_new, pos))
        attn_us = host_us(lambda: decode_from_cache(q, eng.cache, 0, cur, cur, pos, D**-0.5))
        print(f"[profile] host time: cache write_all {write_us:.1f} us a step, "
              f"decode attention call {attn_us:.1f} us a layer")
    if not kernels:
        print("[profile] device busy time: not measured (the profiler saw no CUDA kernels)")
        return 0
    launches = sum(e.count for e in kernels) / per
    print(f"[profile] device busy {busy_ms:.3f} ms/{unit} over {launches:.0f} kernel "
          f"launches/{unit}; idle share {1 - busy_ms / (wall_prof / per * 1e3):.3f} "
          f"of the profiled {unit}")
    print(f"{'kernel':<70} {'calls':>9} {'ms/' + unit:>11} {'avg us':>8}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:25]:
        print(f"{e.key[:70]:<70} {e.count / per:>9.1f} "
              f"{e.self_device_time_total / 1e3 / per:>11.4f} "
              f"{e.self_device_time_total / max(e.count, 1):>8.2f}")
    # where the host's time goes (the profiler's own cost is in every row)
    host = [e for e in prof.key_averages() if e.self_cpu_time_total > 0]
    print(f"{'host op (self CPU time)':<70} {'calls':>9} {'ms/' + unit:>11} {'avg us':>8}")
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:15]:
        print(f"{e.key[:70]:<70} {e.count / per:>9.1f} "
              f"{e.self_cpu_time_total / 1e3 / per:>11.4f} "
              f"{e.self_cpu_time_total / max(e.count, 1):>8.2f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
