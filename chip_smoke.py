#!/usr/bin/env python3
"""Smoke test of the PyTorch port (llamacog_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. environment: torch, CUDA, nvcc, the card's name and power limit;
  2. build every CUDA kernel from llamacog_tpu_torch/csrc (one nvcc per
     source, in parallel) into llamacog_tpu_torch/csrc/build/;
  3. each kernel against its plain PyTorch version at the Llama-3-8B shapes
     of the main path, with kernel, plain, library and bound times: the
     weight kernels, the dense-cache attention kernels, and the
     quantized-cache attention kernels (decode over every K/V kind pair at
     depth 1000, q8_0/q4_0 at depth 32765, the per-layer entries, and
     prefill at write offsets 0 and 896);
  4. the full-width kernel path (8B widths, 2 layers) against the plain
     path (the same params on the CPU): prefill logits and 4
     teacher-forced decode steps, with the dense cache, q8_0, and the split
     q5_1:q4_0 cache;
  5. the 8B Q4_K_M synthetic run through Engine with the dense cache and
     with kv_type="q8_0" (the same params), in turns (dense, q8_0, q8_0,
     dense): 128-token prefill, 128 greedy tokens, with every kernel's
     launch count over each run;
  6. one JSON line of per-kernel results, the card's name and power limit,
     and the final {"ok": true, ...} line.

Weights are random Q4_K_M wire blocks made on the card from a seed.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor-core peak
# tolerances, relative to the largest |reference| value
# qmm: the kernel forms every weight bit for bit as the plain version; only
# the f32 summation order over K <= 14336 terms differs (worst case
# ~K * 2^-24 of the term magnitudes, 9e-4; typically below 2e-5)
TOL_QMM = 1e-4
TOL_ATTN = 1e-2       # bf16 outputs: one bf16 rounding (2^-8) of each side
TOL_PATH = 5e-2       # bf16 model, 2 layers: bf16 roundings that flip between paths
PROMPT_LEN = 128
N_DECODE = 128


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def rel_err(got, ref) -> float:
    got, ref = got.double(), ref.double()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    repo = Path(__file__).resolve().parent
    sys.path.insert(0, str(repo))
    from llamacog_tpu_torch.ops.cuda import build
    from llamacog_tpu_torch.ops.cuda.flash_prefill import (
        flash_prefill_attention_plain, flash_prefill_kernel)
    from llamacog_tpu_torch.ops.cuda.flash_q8 import (
        flash_decode_q8, flash_decode_q8_tiled, flash_decode_stacked,
        flash_decode_stacked_dense, flash_decode_stacked_dense_plain,
        flash_decode_stacked_plain, flash_prefill_q8, flash_prefill_q8_plain)
    from llamacog_tpu_torch.ops.cuda.qmm import qgemm, qmm_plain, qmv
    from llamacog_tpu_torch.runtime.engine import Engine
    from llamacog_tpu_torch.runtime.kv_cache import QuantKVCache, kv_plane_shapes
    from llamacog_tpu_torch.utils.synthetic import (
        llama3_8b_config, make_synthetic_params, random_wire)

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. environment
    nvcc_v = " ".join(line for line in subprocess.run(
        [build.nvcc(), "--version"], capture_output=True, text=True, check=True,
        timeout=60).stdout.splitlines() if "release" in line or "Build" in line)
    card = nvidia_smi_line()
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} | {nvcc_v}")
    log(f"[env] {card} | {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # 2. build
    t0 = time.perf_counter()
    secs = build.build()
    log(f"[build] {time.perf_counter() - t0:.1f}s wall, per source "
        + json.dumps({k: round(v, 1) for k, v in secs.items()}))
    for name, text in build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=dev)

    def time_ms(fn, iters=15, warmup=2) -> float:
        """Median device time of one call (CUDA events), L2 flushed before
        each call by rewriting a 256 MB buffer (untimed)."""
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            flush.zero_()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    results = []

    def record(name, source, replaces, outs, refs, tol, ms, plain_ms, nbytes, flops,
               library_ms=None):
        """Hold a kernel's outputs against its plain version's (relative to
        the largest |reference|, tolerance `tol`) and keep its times."""
        err = max(rel_err(o, r) for o, r in zip(outs, refs))
        abs_err = max(float((o.double() - r.double()).abs().max()) for o, r in zip(outs, refs))
        bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
        by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS else "operations"
        ok = err <= tol
        log(f"[parity] {name}: max abs err {abs_err:.3e}, rel {err:.3e} (tol {tol:.0e}) "
            f"{'ok' if ok else 'FAIL'} | kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound:.4f} ms ({by})"
            + (f", library {library_ms:.4f} ms" if library_ms is not None else ""))
        check(ok, f"{name}: kernel disagrees with its plain version")
        results.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "kernel": source.split("/")[-1][:-3],
                        "max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound, "bound_by": by, "library_ms": library_ms})

    # 3. per-kernel parity at the 8B shapes
    cfg = llama3_8b_config()
    E, F, V = cfg.n_embd, cfg.n_ff, cfg.n_vocab
    g = torch.Generator(device=dev).manual_seed(1234)
    w_qk = random_wire("Q4_K", 5120, E, g, dev)
    w_v = random_wire("Q6_K", 1024, E, g, dev)
    w_o = random_wire("Q4_K", E, E, g, dev)
    w_gu = random_wire("Q4_K", 2 * F, E, g, dev)
    w_d4 = random_wire("Q4_K", E, F, g, dev)
    w_d6 = random_wire("Q6_K", E, F, g, dev)
    w_head = random_wire("Q6_K", V, E, g, dev)
    qmm_src = "llamacog_tpu_torch/csrc/{}.cu"
    qmm_rep = {"qmv": "llamacog_tpu/ops/pallas/qmm.py:453",
               "qgemm": "llamacog_tpu/ops/pallas/qmm.py:453"}
    multi_rep = "llamacog_tpu/ops/pallas/qmm.py:590"
    log("[parity] qmv/qgemm: no single PyTorch call multiplies by GGUF blocks, "
        "so they have no library time (library_ms null)")
    shapes = [("attn_qk+attn_v Q4_K 5120x4096 + Q6_K 1024x4096", [w_qk, w_v], True),
              ("attn_output Q4_K 4096x4096", [w_o], False),
              ("ffn_gate_up Q4_K 28672x4096", [w_gu], False),
              ("ffn_down Q4_K 4096x14336", [w_d4], False),
              ("ffn_down Q6_K 4096x14336", [w_d6], False),
              ("output Q6_K 128256x4096", [w_head], False)]
    for kname, fn, B in (("qmv", qmv, 1), ("qgemm", qgemm, PROMPT_LEN)):
        for label, ws, multi in shapes:
            if kname == "qgemm" and label.startswith("output"):
                continue  # the prefill LM head runs on the last position only: qmv
            K = ws[0].shape[1]
            x = torch.randn(B, K, generator=g, device=dev).to(torch.bfloat16)
            outs = fn(x, ws)
            refs = [qmm_plain(x, w) for w in ws]
            torch.cuda.synchronize()
            nbytes = sum(w.nbytes for w in ws) + x.numel() * 2 + sum(o.numel() * 4 for o in outs)
            flops = sum(2 * B * w.shape[0] * w.shape[1] for w in ws)
            record(f"{kname} B={B} {label}", qmm_src.format(kname),
                   multi_rep if multi else qmm_rep[kname],
                   outs, refs, TOL_QMM,
                   time_ms(lambda: fn(x, ws)), time_ms(lambda: [qmm_plain(x, w) for w in ws],
                                                      iters=5),
                   nbytes, flops)
            del outs, refs

    H, Hkv, D = cfg.n_head, cfg.n_head_kv, cfg.head_dim_k
    rep = H // Hkv
    scale = D ** -0.5
    S = 1024

    def rnd(*s):
        return torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)

    # decode attention: layer 1 of a 2-layer stacked cache, seq_len 1000
    n = 1000
    ks, vs = rnd(2, 1, S, Hkv, D), rnd(2, 1, S, Hkv, D)
    q, kc, vc = rnd(1, H, D), rnd(1, Hkv, D), rnd(1, Hkv, D)
    seq = torch.tensor([n], dtype=torch.int32, device=dev)
    out = flash_decode_stacked_dense(q, ks, vs, 1, kc, vc, seq, scale)
    ref = flash_decode_stacked_dense_plain(q, ks, vs, 1, kc, vc, seq, scale)
    kf = torch.cat([ks[1, :, :n], kc[:, None]], 1).transpose(1, 2).contiguous()
    vf = torch.cat([vs[1, :, :n], vc[:, None]], 1).transpose(1, 2).contiguous()
    qf = q[:, :, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = sdpa(qf, kf, vf, scale=scale, enable_gqa=True)[:, :, 0]
    torch.cuda.synchronize()
    log(f"[library] decode sdpa vs plain: max rel err {rel_err(lib, ref):.3e}")
    record(f"flash_decode_dense H={H} Hkv={Hkv} D={D} S={S} seq_len={n}",
           "llamacog_tpu_torch/csrc/flash_decode_dense.cu",
           "llamacog_tpu/ops/pallas/flash_q8.py:968", [out], [ref], TOL_ATTN,
           time_ms(lambda: flash_decode_stacked_dense(q, ks, vs, 1, kc, vc, seq, scale)),
           time_ms(lambda: flash_decode_stacked_dense_plain(q, ks, vs, 1, kc, vc, seq, scale)),
           2 * (q.numel() + 2 * n * Hkv * D + kc.numel() + vc.numel() + H * D),
           4 * H * (n + 1) * D,
           time_ms(lambda: sdpa(qf, kf, vf, scale=scale, enable_gqa=True)))

    # prefill attention: T=128 over a 1024-slot cache, at write offsets 0
    # (the main path's fresh prompt) and 896 (old-cache tiles too)
    T = PROMPT_LEN
    kl, vl = rnd(1, S, Hkv, D), rnd(1, S, Hkv, D)
    qp, kcp, vcp = rnd(1, T, H, D), rnd(1, T, Hkv, D), rnd(1, T, Hkv, D)
    for n in (0, S - T):
        seq = torch.tensor([n], dtype=torch.int32, device=dev)
        out = flash_prefill_kernel(qp, kl, vl, kcp, vcp, seq, scale)
        ref = flash_prefill_attention_plain(qp, kl, vl, kcp, vcp, seq, scale)
        qs = qp.transpose(1, 2)
        kfull = torch.cat([kl[:, :n], kcp], 1).transpose(1, 2).contiguous()
        vfull = torch.cat([vl[:, :n], vcp], 1).transpose(1, 2).contiguous()
        allowed = (torch.arange(n + T, device=dev)[None, :]
                   <= (n + torch.arange(T, device=dev))[:, None])
        lib = sdpa(qs, kfull, vfull, attn_mask=allowed, scale=scale, enable_gqa=True)
        torch.cuda.synchronize()
        log(f"[library] prefill n={n} sdpa vs plain: max rel err "
            f"{rel_err(lib.transpose(1, 2), ref):.3e}")
        keys = sum(n + t + 1 for t in range(T))
        record(f"flash_prefill T={T} H={H} Hkv={Hkv} D={D} S={S} seq_len={n}",
               "llamacog_tpu_torch/csrc/flash_prefill.cu",
               "llamacog_tpu/ops/pallas/flash_prefill.py:129", [out], [ref], TOL_ATTN,
               time_ms(lambda: flash_prefill_kernel(qp, kl, vl, kcp, vcp, seq, scale)),
               time_ms(lambda: flash_prefill_attention_plain(qp, kl, vl, kcp, vcp, seq,
                                                             scale), iters=5),
               2 * (qp.numel() + 2 * n * Hkv * D + kcp.numel() + vcp.numel() + T * H * D),
               4 * H * keys * D,
               time_ms(lambda: sdpa(qs, kfull, vfull, attn_mask=allowed, scale=scale,
                                    enable_gqa=True)))
    del ks, vs, kl, vl, w_qk, w_v, w_o, w_gu, w_d4, w_d6, w_head
    torch.cuda.empty_cache()

    # quantized-cache attention: layer 1 of a 2-layer stacked plane cache
    # filled with quantized random K/V at every slot
    log("[parity] flash_decode_quant/flash_prefill_quant: no single PyTorch call attends "
        "over quantized KV planes, so they have no library time (library_ms null)")
    fq8 = "llamacog_tpu/ops/pallas/flash_q8.py:{}"

    def quant_cache(kinds, s_len):
        c = QuantKVCache.create(2, 1, s_len, Hkv, D, D, kinds=kinds, device=dev)
        for il in range(2):  # one layer at a time keeps the f32 staging small
            kv = [torch.randn(1, 1, s_len, Hkv, D, generator=g, device=dev) for _ in "kv"]
            part = QuantKVCache([p[il:il + 1] for p in c.k_planes],
                                [p[il:il + 1] for p in c.v_planes], kinds, Hkv)
            part.write_all(*kv, torch.zeros(1, dtype=torch.int32, device=dev))
        return c

    def row_bytes(kind):
        """Plane bytes of one head's row (q values, scales, mins, high bits)."""
        return sum(shp[0] * torch.empty((), dtype=dt).element_size()
                   for shp, dt in kv_plane_shapes(kind, D))

    def decode_row(label, fn, plain, cache, n, source_line, kinds, per_layer):
        seq = torch.tensor([n], dtype=torch.int32, device=dev)
        kp, vp = cache.k_planes, cache.v_planes
        if per_layer:
            kp, vp = [p[1] for p in kp], [p[1] for p in vp]
            args = (q, kp, vp, kc, vc, seq, scale)
        else:
            args = (q, kp, vp, 1, kc, vc, seq, scale)
        out = fn(*args, kinds=kinds)
        ref = plain(q, cache.k_planes, cache.v_planes, 1, kc, vc, seq, scale, kinds=kinds)
        torch.cuda.synchronize()
        nbytes = (n * Hkv * (row_bytes(kinds[0]) + row_bytes(kinds[1]))
                  + 2 * (q.numel() + kc.numel() + vc.numel() + H * D))
        record(f"{label} {kinds[0]}:{kinds[1]} H={H} Hkv={Hkv} D={D} S={cache.max_seq} "
               f"seq_len={n}", "llamacog_tpu_torch/csrc/flash_decode_quant.cu",
               fq8.format(source_line), [out], [ref], TOL_ATTN,
               time_ms(lambda: fn(*args, kinds=kinds)),
               time_ms(lambda: plain(q, cache.k_planes, cache.v_planes, 1, kc, vc, seq, scale,
                                     kinds=kinds), iters=5),
               nbytes, 4 * H * (n + 1) * D)

    pairs = [(k, k) for k in ("q8_0", "q4_0", "q4_1", "q5_0", "q5_1")] + [
        ("q8_0", "q5_1"), ("q5_0", "q4_1"), ("bf16", "q4_0"), ("q8_0", "f16")]
    for kinds in pairs:
        cache = quant_cache(kinds, S)
        decode_row("flash_decode_stacked", flash_decode_stacked, flash_decode_stacked_plain,
                   cache, 1000, 828, kinds, False)
        if kinds == ("q8_0", "q8_0"):  # the per-layer entry on planes[il] views (K8a)
            decode_row("flash_decode_q8", flash_decode_q8, flash_decode_stacked_plain,
                       cache, 1000, 187, kinds, True)
        del cache
    for kind in ("q8_0", "q4_0"):  # at depth, and the tiled per-layer entry (K8b)
        cache = quant_cache((kind, kind), 32768)
        decode_row("flash_decode_stacked", flash_decode_stacked, flash_decode_stacked_plain,
                   cache, 32765, 828, (kind, kind), False)
        if kind == "q8_0":
            decode_row("flash_decode_q8_tiled", flash_decode_q8_tiled,
                       flash_decode_stacked_plain, cache, 32765, 520, (kind, kind), True)
        del cache
        torch.cuda.empty_cache()
    for kinds in (("q8_0", "q8_0"), ("q4_0", "q4_0"), ("q8_0", "q5_1")):
        cache = quant_cache(kinds, S)
        kp, vp = [p[1] for p in cache.k_planes], [p[1] for p in cache.v_planes]
        for n in (0, S - T):
            seq = torch.tensor([n], dtype=torch.int32, device=dev)
            args = (qp, kp, vp, kcp, vcp, seq, scale)
            out = flash_prefill_q8(*args, kinds=kinds)
            ref = flash_prefill_q8_plain(*args, kinds=kinds)
            torch.cuda.synchronize()
            keys = sum(n + t + 1 for t in range(T))
            record(f"flash_prefill_q8 {kinds[0]}:{kinds[1]} T={T} H={H} Hkv={Hkv} D={D} "
                   f"S={S} seq_len={n}", "llamacog_tpu_torch/csrc/flash_prefill_quant.cu",
                   fq8.format(331), [out], [ref], TOL_ATTN,
                   time_ms(lambda: flash_prefill_q8(*args, kinds=kinds)),
                   time_ms(lambda: flash_prefill_q8_plain(*args, kinds=kinds), iters=5),
                   n * Hkv * (row_bytes(kinds[0]) + row_bytes(kinds[1]))
                   + 2 * (qp.numel() + kcp.numel() + vcp.numel() + T * H * D),
                   4 * H * keys * D)
        del cache
    torch.cuda.empty_cache()

    # 4. full-width kernel path vs the plain path (same params on the CPU)
    cfg2 = llama3_8b_config(n_layer=2)
    p_gpu = make_synthetic_params(cfg2, seed=7)
    p_cpu = {k: (v if k == "layers" else v.to("cpu")) for k, v in p_gpu.items()}
    p_cpu["layers"] = [{k: v.to("cpu") for k, v in layer.items()} for layer in p_gpu["layers"]]
    prompt = [(i * 7919) % V for i in range(2, 22)]
    forced = [11, 12345, 777, 90000]
    t0 = time.perf_counter()
    # the dense cache, q8_0, and a split pair; a second prefill chunk at the
    # end attends the (quantized) cache of the first
    for kv_type in ("dense", "q8_0", "q5_1:q4_0"):
        runs = {}
        for name, params, device in (("kernel", p_gpu, "cuda"), ("plain", p_cpu, "cpu")):
            eng = Engine(params, cfg2, batch_size=1, max_seq=1024, kv_type=kv_type,
                         device=device)
            steps = [eng.prefill(prompt)]
            for tok in forced:
                steps.append(eng.decode_one([tok])[0])
            steps.append(eng.prefill(prompt[:9]))
            runs[name] = steps
        for i, (a, b) in enumerate(zip(runs["kernel"], runs["plain"])):
            err = rel_err(torch.from_numpy(a), torch.from_numpy(b))
            what = ("prefill" if i == 0 else "prefill chunk 2" if i == len(forced) + 1
                    else f"decode step {i}")
            what = f"kv {kv_type}, {what}"
            check(a.shape == (V,) and bool(torch.isfinite(torch.from_numpy(a)).all()),
                  f"{what}: logits not finite of shape [{V}]")
            log(f"[path] 8B widths, 2 layers, {what}: logits max rel err {err:.3e} "
                f"(tol {TOL_PATH:.0e}), argmax kernel {int(a.argmax())} "
                f"plain {int(b.argmax())}")
            check(err <= TOL_PATH, f"kernel path disagrees with the plain path at {what}")
    log(f"[path] done in {time.perf_counter() - t0:.1f}s")
    del p_gpu, p_cpu, runs
    torch.cuda.empty_cache()

    # 5. the 8B Q4_K_M synthetic run through the engine
    t0 = time.perf_counter()
    params = make_synthetic_params(cfg, seed=0)
    torch.cuda.synchronize()
    log(f"[8b] synthetic Q4_K_M params built in {time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    prompt = [(i * 31337) % V for i in range(PROMPT_LEN)]
    # which kernels each run must launch, and which it must not
    paths = {
        "dense": (("qmv", "qgemm", "flash_decode_dense", "flash_prefill"),
                  ("flash_decode_quant", "flash_prefill_quant")),
        "q8_0": (("qmv", "qgemm", "flash_decode_quant", "flash_prefill_quant"),
                 ("flash_decode_dense", "flash_prefill")),
    }
    path_launches = {}
    # in turns (dense, q8_0, q8_0, dense): host time drifts within a process
    for i, kv_type in enumerate(("dense", "q8_0", "q8_0", "dense")):
        used, unused = paths[kv_type]
        eng = Engine(params, cfg, batch_size=1, max_seq=1024, kv_type=kv_type)
        c = eng.cache
        kv_bytes = sum(t.nbytes for t in ((c.k_planes + c.v_planes)
                                          if isinstance(c, QuantKVCache) else (c.k, c.v)))
        ttfts = []
        for _ in range(4):  # the first is a warm-up (allocator, first launches)
            eng.reset()
            t0 = time.perf_counter()
            eng.prefill(prompt)
            ttfts.append(time.perf_counter() - t0)
        ttft = statistics.median(ttfts[1:])
        # the main-path run whose launches are counted: prefill + greedy decode
        eng.reset()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        logits = eng.prefill(prompt)
        prefill_launches = dict(build.LAUNCHES)
        t1 = time.perf_counter()
        toks = eng.decode_greedy_tokens([int(logits.argmax())], N_DECODE)
        dt = time.perf_counter() - t1
        launches = dict(build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        tag = f"[8b kv {kv_type} run {i + 1}]"
        check(logits.shape == (V,) and bool(torch.isfinite(torch.from_numpy(logits)).all()),
              f"{tag} prefill logits not finite of the expected shape")
        check(toks.shape == (1, N_DECODE) and 0 <= toks.min() and toks.max() < V,
              f"{tag} greedy tokens out of shape or range")
        decode_launches = {k: launches[k] - prefill_launches[k] for k in launches}
        log(f"{tag} KV cache {kv_bytes / 1e6:.1f} MB at max_seq 1024")
        log(f"{tag} TTFT {ttft * 1e3:.2f} ms (median of 3 prefills of {PROMPT_LEN} tokens; "
            f"all: {', '.join(f'{t * 1e3:.2f}' for t in ttfts)} ms)")
        log(f"{tag} decode {N_DECODE} tokens in {dt:.3f}s: {N_DECODE / dt:.2f} tokens/s, "
            f"{dt / N_DECODE * 1e3:.3f} ms/token; weight-stream bound "
            f"{sum_wire_bytes(params) / HBM_BYTES_PER_S * 1e3:.3f} ms/token")
        log(f"{tag} launches: prefill {json.dumps(prefill_launches)}, "
            f"decode {json.dumps(decode_launches)}")
        log(f"{tag} peak device memory {peak / 2**30:.2f} GiB")
        missing = [k for k in used if launches[k] == 0]
        check(not missing, f"{tag} kernels never launched on the main path: {missing}")
        stray = [k for k in unused if launches[k] != 0]
        check(not stray, f"{tag} kernels of another cache path launched: {stray}")
        path_launches[kv_type] = launches
        # the device-side loop agrees with host-driven decode_one + argmax
        eng.reset()
        first = int(eng.prefill(prompt).argmax())
        host_toks, tok = [], first
        for _ in range(8):
            tok = int(eng.decode_one([tok])[0].argmax())
            host_toks.append(tok)
        check(host_toks == [int(t) for t in toks[0, :8]],
              f"{tag} greedy loop {toks[0, :8]} != decode_one {host_toks}")
        log(f"{tag} greedy loop and decode_one agree on the first 8 tokens: {host_toks}")
        del eng, c
        torch.cuda.empty_cache()

    # 6. results
    # each kernel's launches in the run of its cache path
    for r in results:
        k = r.pop("kernel")
        r["launches"] = path_launches["q8_0" if k in paths["dense"][1] else "dense"][k]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in results]}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def sum_wire_bytes(params: dict) -> int:
    """Bytes one decode step must stream: every layer weight and the LM
    head (the embedding table is gathered by row, not streamed)."""
    from llamacog_tpu_torch.quant.wire import WireTensor

    total = params["output"].nbytes
    for layer in params["layers"]:
        total += sum(v.nbytes for v in layer.values() if isinstance(v, WireTensor))
    return total


if __name__ == "__main__":
    sys.exit(main())
