"""Where the time of a decode step (or of a prefill) goes, on the GPU.

    python -m llamacog_tpu_torch.tools.profile [--model mixtral-8x7b] [--layers 32] \
        [--steps 32] [--kv-type q8_0] [--prompt 512 --prefill] [--max-seq 8192] \
        [--ftype IQ3_XXS] [--batch 4]

Builds the synthetic model of the configuration --model (utils/synthetic.py
CONFIGS: llama3-8b by default, mixtral-8x7b, qwen2.5-7b, qwen3-30b-a3b,
gemma3-12b, the MoE variants deepseek-moe-16b, dots1, ling-lite,
phi3.5-moe, grok-1, dbrx and arctic (the last three with --layers 4 or so:
at their full depth they do not fit on one card), the last decoders
minicpm3-4b, plm-1.8b, glm4-9b-0414, glm-4-9b-chat, chameleon-7b,
chameleon-30b, bitnet-b1.58-large (with --ftype TQ2_0 or TQ1_0), openelm-3b
and deci-51b (--layers 6 or so: one period of its pattern), ...) in the weight
preset --ftype (each tensor of the kind
llama.cpp's rules give it, for a codebook preset those of a file made
with an importance matrix, as the public IQ files are; by default
utils/synthetic.py's DEFAULT_LAYOUT, Q4_K_M with every attn_v Q6_K) (depth
cut by --layers) with an Engine of --max-seq
slots (1024 by default) and prefills a --prompt-token prompt (128). With
--batch B the Engine has B rows, each prefilled with a prompt of its own
(the serving step: a MoE layer sends B x top-k rows through the expert
gather, K10), a decode step advances all B rows, and the decode numbers
are per step of B tokens. Decode
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
step; and where the forward attends through the masked path (Llama 4's
chunked layers, every layer of an ALiBi model (bloom-7b1, mpt-7b,
jais-13b, refact-1.6b), a ring's window layers, a quantized cache at a head
dim that 32 does not divide), that path's device time a token and its share of
the graph step's device busy time (its calls wrapped in a profiler range
in an eager run: the range's device time is that of the kernels launched
in it). If the profiler sees no CUDA kernels, the device numbers are
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
    from ..utils.synthetic import CONFIGS

    ap.add_argument("--model", choices=sorted(CONFIGS), default="llama3-8b")
    ap.add_argument("--layers", type=int, default=None,
                    help="depth (default: the configuration's published depth)")
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--prompt", type=int, default=128)
    ap.add_argument("--max-seq", type=int, default=1024)
    ap.add_argument("--kv-type", default="dense", help="KV cache kinds, as Engine's kv_type")
    ap.add_argument("--prefill", action="store_true",
                    help="profile one prefill of the prompt instead of the decode steps")
    ap.add_argument("--batch", type=int, default=1,
                    help="rows of the Engine, each with its own prompt; decode steps all rows")
    ap.add_argument("--ftype", default=None,
                    help="weight preset of the synthetic model (utils/synthetic.py PRESETS; "
                         "DEFAULT_LAYOUT if not given)")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from ..models import llama as llama_mod

    from ..ops.cuda.flash_q8 import decode_from_cache
    from ..runtime.engine import Engine
    from ..utils.synthetic import CODEBOOK_PRESETS, DEFAULT_LAYOUT, make_synthetic_params

    cfg = CONFIGS[args.model](**({} if args.layers is None else {"n_layer": args.layers}))
    params = make_synthetic_params(cfg, seed=0, ftype=args.ftype or DEFAULT_LAYOUT,
                                   imatrix=args.ftype in CODEBOOK_PRESETS)
    B = args.batch
    eng = Engine(params, cfg, batch_size=B, max_seq=args.max_seq, kv_type=args.kv_type)
    prompts = [[(i * 31337 + 977 * r) % cfg.n_vocab for i in range(args.prompt)]
               for r in range(B)]

    def prefill() -> list:
        """Each row's prompt; the rows' first greedy tokens."""
        eng.reset()  # each prefill ends in a device->host copy
        return [int(eng.prefill(p, row=r).argmax()) for r, p in enumerate(prompts)]

    def timed_prefill() -> float:
        t0 = time.perf_counter()
        prefill()
        return time.perf_counter() - t0

    def report(prof, wall_prof, per, unit, label) -> None:
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if not kernels:
            print(f"[profile] {label}: device busy time: not measured (the profiler saw no "
                  "CUDA kernels)")
            return None
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
        return busy_ms

    def host_ops(prof, per, unit) -> None:
        """Where the host's time goes (the profiler's own cost is in every row)."""
        host = [e for e in prof.key_averages() if e.self_cpu_time_total > 0]
        print(f"{'host op (self CPU time)':<70} {'calls':>9} {'ms/' + unit:>11} {'avg us':>8}")
        for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:15]:
            print(f"{e.key[:70]:<70} {e.count / per:>9.1f} "
                  f"{e.self_cpu_time_total / 1e3 / per:>11.4f} "
                  f"{e.self_cpu_time_total / max(e.count, 1):>8.2f}")

    head = (f"[profile] {torch.cuda.get_device_name(0)}, {args.model}, {cfg.n_layer} layers, "
            f"kv {args.kv_type}, a {args.prompt}-token prompt" + (f" in each of {B} rows"
                                                                  if B > 1 else ""))
    unit = "token" if B == 1 else "step"

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
        firsts = prefill()
        t0 = time.perf_counter()
        ways[way](firsts, args.steps)  # ends in a device->host copy
        return time.perf_counter() - t0

    for way in ways:
        decode(way)  # warm-up; the graph way captures the step
    walls = {way: [] for way in ways}
    for way in ("graph", "eager", "eager", "graph"):
        walls[way].append(decode(way) / args.steps * 1e3)
    print(f"{head}: {args.steps} decode steps after the prompt")
    print(f"[profile] host clock, ms/{unit} (in turns): "
          + "; ".join(f"{way} {', '.join(f'{t:.3f}' for t in ts)}" for way, ts in walls.items()))
    profs, busy = {}, {}
    for way in ways:
        firsts = prefill()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            ways[way](firsts, args.steps)
            wall_prof = time.perf_counter() - t0
        profs[way] = prof
        busy[way] = report(prof, wall_prof, args.steps, unit, way)

    orig_masked = llama_mod.masked_attention

    def ranged(*a, **kw):
        with record_function("masked_attention"):
            return orig_masked(*a, **kw)

    llama_mod.masked_attention = ranged
    try:
        firsts = prefill()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            ways["eager"](firsts, args.steps)
    finally:
        llama_mod.masked_attention = orig_masked
    masked = [e for e in prof.key_averages() if e.key == "masked_attention"]
    if masked:
        m_ms = masked[0].device_time_total / 1e3 / args.steps
        share = (f"{m_ms / busy['graph']:.3f} of the graph step's device busy time"
                 if busy.get("graph") else "its share not measured")
        print(f"[profile] masked attention (the plain path): {masked[0].count / args.steps:.1f} "
              f"calls/{unit}, {m_ms:.3f} ms/{unit} of device time (its kernels, eager step), "
              f"{share}")

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

    L, H, Hkv = cfg.n_layer, cfg.n_head, cfg.n_head_kv
    Dk, Dv = cfg.head_dim_k, cfg.head_dim_v  # MLA: 192/128 on deepseek2, 96/64 on minicpm3
    dev = eng.device
    k_new, v_new = (torch.zeros((L, B, 1, Hkv, d), dtype=eng.dtype, device=dev) for d in (Dk, Dv))
    q, k_cur, v_cur = (torch.zeros((B, h, d), dtype=eng.dtype, device=dev)
                       for h, d in ((H, Dk), (Hkv, Dk), (Hkv, Dv)))
    pos = torch.full((B,), args.prompt, dtype=torch.int32, device=dev)
    write_us = host_us(lambda: eng.cache.write_all(k_new, v_new, pos))
    attn_us = host_us(lambda: decode_from_cache(q, eng.cache, 0, k_cur, v_cur, pos, Dk**-0.5))
    print(f"[profile] eager host time: cache write_all {write_us:.1f} us a step, "
          f"decode attention call {attn_us:.1f} us a layer")
    host_ops(profs["eager"], args.steps, unit)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
