#!/usr/bin/env python3
"""Smoke test of the PyTorch port (llamacog_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. environment: torch, CUDA, nvcc, the card's name and power limit;
  2. build every CUDA kernel from llamacog_tpu_torch/csrc (one nvcc per
     source, in parallel) into llamacog_tpu_torch/csrc/build/;
  3. each kernel against its plain PyTorch version at the Llama-3-8B shapes
     of the main path, with kernel, plain, library and bound times: the
     weight kernels, the int8 prefill GEMM (K13) at the five layer shapes
     at 512 rows and ragged 300, the dense-cache attention kernels (the
     stacked K4 and the per-layer K9), and the quantized-cache attention
     kernels (decode over every K/V kind pair at depth 1000, q8_0/q4_0 at
     depth 32765, the per-layer entries, and prefill at write offsets 0
     and 896); then the MoE kernels at the Mixtral-8x7B expert shapes (the
     gather at 2 and 32 rows, the offset entry, the grouped GEMM of a
     128-token prefill);
  4. the full-width kernel path (8B widths, 2 layers) against the plain
     path (the same params on the CPU): prefill logits, 4 teacher-forced
     decode steps and a 9-token second chunk, with the dense cache, q8_0,
     the split q5_1:q4_0 cache, LLAMACOG_MMQ=1 on a 300-token prompt (int8
     prefill), and the per-layer decode routes (LLAMACOG_FLASH_STACKED=0:
     K9 on the dense cache with LLAMACOG_FLASH_DECODE=1, K8 on q8_0); then
     the same at Mixtral widths (2 layers, dense cache): a 20-token
     prefill (grouped GEMM), 4 decode steps and a 9-token second chunk
     (gather);
  5. the 8B Q4_K_M synthetic run through Engine at full depth, in turns:
     the dense cache and kv_type="q8_0" (dense, q8_0, q8_0, dense;
     128-token prefill, 128 greedy tokens), a 512-token prompt exact and
     with LLAMACOG_MMQ=1 (exact, mmq, mmq, exact), and the per-layer dense
     decode route (K9), whose greedy tokens must equal the stacked
     route's; every kernel's launch count over each run; then, with the 8B
     params freed, the Mixtral-8x7B Q4_K_M synthetic run at full depth (32
     layers), the same way;
  6. one JSON line of per-kernel results, the card's name and power limit,
     and the final {"ok": true, ...} line.

Weights are random Q4_K_M wire blocks made on the card from a seed.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor-core peak
INT8_OPS = 1979e12         # H100 SXM dense int8 tensor-core peak
# tolerances, relative to the largest |reference| value
# qmm: the kernel forms every weight bit for bit as the plain version; only
# the f32 summation order over K <= 14336 terms differs (worst case
# ~K * 2^-24 of the term magnitudes, 9e-4; typically below 2e-5)
TOL_QMM = 1e-4
# qmm_i8: the same integer block products and the same f32 combine,
# operation for operation, as the plain version: bit parity expected
TOL_K13 = 1e-6
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


@contextlib.contextmanager
def env_vars(values: dict):
    """Set the environment variables `values` for the block, then restore
    the previous environment."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    repo = Path(__file__).resolve().parent
    sys.path.insert(0, str(repo))
    from llamacog_tpu_torch.ops.cuda import build
    from llamacog_tpu_torch.ops.cuda import flash_decode as flash_decode_mod
    from llamacog_tpu_torch.ops.cuda import flash_q8 as flash_q8_mod
    from llamacog_tpu_torch.ops.cuda.flash_decode import (
        flash_decode_attention_plain, flash_decode_kernel)
    from llamacog_tpu_torch.ops.cuda.flash_prefill import (
        flash_prefill_attention_plain, flash_prefill_kernel)
    from llamacog_tpu_torch.ops.cuda.flash_q8 import (
        flash_decode_q8, flash_decode_q8_tiled, flash_decode_stacked,
        flash_decode_stacked_dense, flash_decode_stacked_dense_plain,
        flash_decode_stacked_plain, flash_prefill_q8, flash_prefill_q8_plain)
    from llamacog_tpu_torch.models.llama import _ffn_moe, moe_sort
    from llamacog_tpu_torch.ops.linear import qmatmul
    from llamacog_tpu_torch.ops.cuda.qmm import qgemm, qmm_plain, qmv
    from llamacog_tpu_torch.ops.cuda.qmm_i8 import (
        qmm_i8_kernel, qmm_i8_plain, quantize_activations)
    from llamacog_tpu_torch.ops.cuda.qmm_id import (
        qmm_gather, qmm_gather_offset, qmm_gather_plain, qmm_ragged, qmm_ragged_plain)
    from llamacog_tpu_torch.quant.mmq import build_mmq_planes
    from llamacog_tpu_torch.quant.wire import WireTensor
    from llamacog_tpu_torch.runtime.engine import Engine
    from llamacog_tpu_torch.runtime.kv_cache import QuantKVCache, kv_plane_shapes
    from llamacog_tpu_torch.utils.synthetic import (
        llama3_8b_config, make_synthetic_params, mixtral_8x7b_config, random_experts,
        random_wire)

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

    def time_interleaved_ms(fns, iters=31, warmup=2) -> list:
        """time_ms of each of fns, the calls taken in turns within one loop
        so that a drift of the card's clocks reaches all of them alike.
        Logs each one's spread (min-max)."""
        for _ in range(warmup):
            for fn in fns:
                fn()
        times = [[] for _ in fns]
        for _ in range(iters):
            for fn, t in zip(fns, times):
                flush.zero_()
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                fn()
                b.record()
                torch.cuda.synchronize()
                t.append(a.elapsed_time(b))
        log("[timing] interleaved: " + ", ".join(
            f"median {statistics.median(t):.4f} ms (min {min(t):.4f}, max {max(t):.4f})"
            for t in times))
        return [statistics.median(t) for t in times]

    results = []

    def no_sync(fn):
        """fn() with any call that makes the host wait for the card raising."""
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")

    probe = torch.ones(4, device=dev)
    try:  # the mode has teeth: a device-to-host read raises under it
        no_sync(lambda: bool(probe.isfinite().all()))
        flagged = False
    except RuntimeError:
        flagged = True
    check(flagged, "torch.cuda.set_sync_debug_mode did not flag a host sync")

    def record(name, source, replaces, outs, refs, tol, ms, plain_ms, nbytes, flops,
               library_ms=None, peak=BF16_FLOPS, counter=None):
        """Hold a kernel's outputs against its plain version's (relative to
        the largest |reference|, tolerance `tol`) and keep its times. The
        bound is the larger of nbytes over the HBM rate and flops over
        `peak` (the tensor-core rate of the operands' type); `counter` is
        the launch count the row reads (the source's name by default)."""
        err = max(rel_err(o, r) for o, r in zip(outs, refs))
        abs_err = max(float((o.double() - r.double()).abs().max()) for o, r in zip(outs, refs))
        bound = max(nbytes / HBM_BYTES_PER_S, flops / peak) * 1e3
        by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / peak else "operations"
        ok = err <= tol
        log(f"[parity] {name}: max abs err {abs_err:.3e}, rel {err:.3e} (tol {tol:.0e}) "
            f"{'ok' if ok else 'FAIL'} | kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound:.4f} ms ({by})"
            + (f", library {library_ms:.4f} ms" if library_ms is not None else ""))
        check(ok, f"{name}: kernel disagrees with its plain version")
        results.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "kernel": counter or source.split("/")[-1][:-3],
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

    # the int8 prefill GEMM (K13, LLAMACOG_MMQ=1) over the planes of the five
    # 8B layer weights, at a 512-row prefill chunk and a ragged 300
    log("[parity] qmm_i8: the library time is torch._int_mm(xq, qi8.T), the int32 "
        "products alone, without the per-block weight scales and the row scales; "
        "qmatmul's int8 route runs each shape once with host syncs raising")
    i8_shapes = [("attn_qk Q4_K 5120x4096", w_qk), ("attn_v Q6_K 1024x4096", w_v),
                 ("attn_output Q4_K 4096x4096", w_o), ("ffn_gate_up Q4_K 28672x4096", w_gu),
                 ("ffn_down Q4_K 4096x14336", w_d4)]
    for label, w, B in [(lb, w, 512) for lb, w in i8_shapes] + [(*i8_shapes[3], 300)]:
        qi8, ws8T = build_mmq_planes(w)
        N, K = w.shape
        x = torch.randn(B, K, generator=g, device=dev).to(torch.bfloat16)
        xq, xs = quantize_activations(x)
        out = qmm_i8_kernel(xq, xs, qi8, ws8T)
        ref = qmm_i8_plain(xq, xs, qi8, ws8T)
        torch.cuda.synchronize()
        record(f"qmm_i8 B={B} {label}", qmm_src.format("qmm_i8"),
               "llamacog_tpu/ops/pallas/qmm_i8.py:68", [out], [ref], TOL_K13,
               time_ms(lambda: qmm_i8_kernel(xq, xs, qi8, ws8T)),
               time_ms(lambda: qmm_i8_plain(xq, xs, qi8, ws8T), iters=5),
               xq.numel() + xs.numel() * 4 + qi8.numel() + ws8T.numel() * 4 + out.numel() * 4,
               2 * B * N * K, time_ms(lambda: torch._int_mm(xq, qi8.t())), peak=INT8_OPS)
        if B == 512:
            log(f"[route] qgemm B=512 {label} (the route K13 replaces): "
                f"{time_ms(lambda: qgemm(x, [w])):.4f} ms")
        # the model's int8 route (activation quantization, then K13) never
        # makes the host wait for the card
        w8 = WireTensor(w.kind, w.shape, w.blocks, qi8, ws8T)
        check(torch.equal(no_sync(lambda: qmatmul(x, w8)), ref.to(torch.bfloat16)),
              f"qmatmul {label}: the int8 route disagrees with qmm_i8_plain")
        del qi8, ws8T, out, ref, w8

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
    # K4 and the per-layer K9 below launch one kernel on the same layer:
    # they are timed in turns, K4 first
    log("[timing] K4 (stacked) and K9 (per-layer), the same kernel on layer 1:")
    k4_ms, k9_ms = time_interleaved_ms(
        [lambda: flash_decode_stacked_dense(q, ks, vs, 1, kc, vc, seq, scale),
         lambda: flash_decode_kernel(q, ks[1], vs[1], kc, vc, seq, scale)])
    record(f"flash_decode_dense H={H} Hkv={Hkv} D={D} S={S} seq_len={n}",
           "llamacog_tpu_torch/csrc/flash_decode_dense.cu",
           "llamacog_tpu/ops/pallas/flash_q8.py:968", [out], [ref], TOL_ATTN, k4_ms,
           time_ms(lambda: flash_decode_stacked_dense_plain(q, ks, vs, 1, kc, vc, seq, scale)),
           2 * (q.numel() + 2 * n * Hkv * D + kc.numel() + vc.numel() + H * D),
           4 * H * (n + 1) * D,
           time_ms(lambda: sdpa(qf, kf, vf, scale=scale, enable_gqa=True)))
    # the per-layer entry (K9, LLAMACOG_FLASH_STACKED=0 LLAMACOG_FLASH_DECODE=1)
    # on the same layer as one [B, S, Hkv, D] tensor
    out = flash_decode_kernel(q, ks[1], vs[1], kc, vc, seq, scale)
    ref = flash_decode_attention_plain(q, ks[1], vs[1], kc, vc, seq, scale)
    torch.cuda.synchronize()
    record(f"flash_decode H={H} Hkv={Hkv} D={D} S={S} seq_len={n}",
           "llamacog_tpu_torch/csrc/flash_decode_dense.cu",
           "llamacog_tpu/ops/pallas/flash_decode.py:84", [out], [ref], TOL_ATTN, k9_ms,
           time_ms(lambda: flash_decode_attention_plain(q, ks[1], vs[1], kc, vc, seq, scale)),
           2 * (q.numel() + 2 * n * Hkv * D + kc.numel() + vc.numel() + H * D),
           4 * H * (n + 1) * D,
           time_ms(lambda: sdpa(qf, kf, vf, scale=scale, enable_gqa=True)),
           counter="flash_decode")

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
    del ks, vs, kl, vl, shapes, ws, x, xq, xs, i8_shapes, w, w_qk, w_v, w_o, w_gu, w_d4, w_d6, \
        w_head
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

    # MoE kernels at the Mixtral-8x7B expert shapes. Routing is top-2 of 8
    # from random router logits, as the model's; a row's expert is read once
    # per distinct expert in the bound (the data's need), and the grouped
    # GEMM's bound counts the real (token, slot) rows, not the padding.
    mcfg = mixtral_8x7b_config()
    n_exp, k_used, Fm = mcfg.n_expert, mcfg.n_expert_used, mcfg.n_ff
    moe_gu = random_experts("Q4_K", n_exp, 2 * Fm, E, g, dev)
    moe_d6 = random_experts("Q6_K", n_exp, E, Fm, g, dev)
    qid_rep = "llamacog_tpu/ops/pallas/qmm_id.py:{}"
    log("[parity] qmv_id/qgemm_id: no single PyTorch call multiplies by GGUF blocks, "
        "so they have no library time (library_ms null)")

    def route(tokens):
        """Top-2 expert ids [tokens * 2] of random router logits."""
        logits = torch.randn(tokens, n_exp, generator=g, device=dev)
        return torch.topk(logits, k_used, dim=-1).indices.reshape(-1).to(torch.int32)

    def expert_bytes(w, ids):
        return w.nbytes // n_exp * len(set(ids.tolist()))

    for label, w, tokens, fn, line in (
            ("qmv_id gather ffn_gate_up_exps Q4_K 8x28672x4096", moe_gu, 1, qmm_gather, 115),
            ("qmv_id gather ffn_gate_up_exps Q4_K 8x28672x4096", moe_gu, 16, qmm_gather, 115),
            ("qmv_id gather ffn_down_exps Q6_K 8x4096x14336", moe_d6, 1, qmm_gather, 115),
            ("qmv_id offset ffn_gate_up_exps Q4_K 8x28672x4096", moe_gu, 1, qmm_gather_offset,
             267)):
        ids = route(tokens)
        S_rows, (_, Nw, Kw) = ids.shape[0], w.shape
        x = torch.randn(S_rows, Kw, generator=g, device=dev).to(torch.bfloat16)
        out, ref = fn(x, ids, w), qmm_gather_plain(x, ids, w)
        torch.cuda.synchronize()
        record(f"{label} S={S_rows}", qmm_src.format("qmv_id"), qid_rep.format(line), [out],
               [ref], TOL_QMM, time_ms(lambda: fn(x, ids, w)),
               time_ms(lambda: qmm_gather_plain(x, ids, w), iters=5),
               expert_bytes(w, ids) + x.numel() * 2 + out.numel() * 4, 2 * S_rows * Nw * Kw)
    # the grouped GEMM of a 128-token prefill: 256 rows sorted by expert,
    # padded to 64-row tiles, s_pad 768
    ids = route(PROMPT_LEN)
    dest, tile_expert, s_pad = moe_sort(ids, n_exp, 64)
    for label, w in (("ffn_gate_up_exps Q4_K 8x28672x4096", moe_gu),
                     ("ffn_down_exps Q6_K 8x4096x14336", moe_d6)):
        _, Nw, Kw = w.shape
        rows = torch.randn(ids.shape[0], Kw, generator=g, device=dev).to(torch.bfloat16)
        xs = torch.zeros(s_pad, Kw, dtype=torch.bfloat16, device=dev).index_copy_(0, dest, rows)
        out = qmm_ragged(xs, tile_expert, w, 64)
        ref = qmm_ragged_plain(xs, tile_expert, w, 64)
        torch.cuda.synchronize()
        record(f"qgemm_id ragged {label} tokens={PROMPT_LEN} rows={ids.shape[0]} "
               f"s_pad={s_pad}", qmm_src.format("qgemm_id"), qid_rep.format(188), [out], [ref],
               TOL_QMM, time_ms(lambda: qmm_ragged(xs, tile_expert, w, 64)),
               time_ms(lambda: qmm_ragged_plain(xs, tile_expert, w, 64), iters=5),
               expert_bytes(w, ids) + ids.shape[0] * (Kw * 2 + Nw * 4),
               2 * ids.shape[0] * Nw * Kw)
    # the MoE FFN keeps routing on the device: a decode step (2 rows, the
    # gather) and a 128-token prefill (the grouped GEMM) run with any
    # synchronizing call raising
    moe_layer = {"ffn_gate_inp": torch.randn(n_exp, E, generator=g, device=dev) * 0.02,
                 "ffn_gate_up_exps": moe_gu, "ffn_down_exps": moe_d6}

    for T_moe in (1, PROMPT_LEN):
        h_moe = torch.randn(1, T_moe, E, generator=g, device=dev).to(torch.bfloat16)
        out = no_sync(lambda: _ffn_moe(moe_layer, h_moe, mcfg))
        check(out.shape == h_moe.shape and bool(torch.isfinite(out).all()),
              f"MoE FFN at T={T_moe}: output not finite of shape {tuple(h_moe.shape)}")
        log(f"[moe] _ffn_moe T={T_moe} ({T_moe * k_used} rows) ran with no host sync")
    del moe_gu, moe_d6, moe_layer, w, x, rows, xs, out, ref  # `w` holds a stack too
    torch.cuda.empty_cache()

    # 4. full-width kernel path vs the plain path (same params on the CPU)
    t0 = time.perf_counter()
    route_fns = ((flash_q8_mod, "decode_from_cache", "stacked"),
                 (flash_q8_mod, "flash_decode_q8_auto", "per-layer quantized"),
                 (flash_decode_mod, "flash_decode_attention", "per-layer dense"))

    @contextlib.contextmanager
    def route_calls():
        """Count the forward's calls of each T=1 attention route (wrappers on
        the module functions it calls, restored after the block)."""
        calls = {name: 0 for _, _, name in route_fns}
        saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in route_fns]
        for (mod, attr, fn), (_, _, name) in zip(saved, route_fns):
            def counted(*a, _fn=fn, _name=name, **kw):
                calls[_name] += 1
                return _fn(*a, **kw)
            setattr(mod, attr, counted)
        try:
            yield calls
        finally:
            for mod, attr, fn in saved:
                setattr(mod, attr, fn)

    def two_copies(cfgp):
        p_gpu = make_synthetic_params(cfgp, seed=7)
        p_cpu = {k: (v if k == "layers" else v.to("cpu")) for k, v in p_gpu.items()}
        p_cpu["layers"] = [{k: v.to("cpu") for k, v in layer.items()}
                           for layer in p_gpu["layers"]]
        return p_gpu, p_cpu

    def path_check(model, cfgp, p_gpu, p_cpu, cases, forced, max_seq):
        """For each case (label, kv type, environment, prompt, kernels that
        must launch, the T=1 attention route that must run), under the
        case's environment: prefill, teacher-forced decode steps and a
        9-token second chunk (which attends the cache of the first) through
        Engine on the card and on the CPU, the same params; logits held
        within TOL_PATH. Returns the card's first prefill logits per case."""
        Vp = cfgp.n_vocab
        firsts = {}
        for label, kv_type, env, prompt, must, route in cases:
            runs = {}
            with env_vars(env):
                for name, params, device in (("kernel", p_gpu, "cuda"), ("plain", p_cpu, "cpu")):
                    eng = Engine(params, cfgp, batch_size=1, max_seq=max_seq, kv_type=kv_type,
                                 device=device)
                    build.reset_launches()
                    with route_calls() as calls:
                        steps = [eng.prefill(prompt)]
                        for tok in forced:
                            steps.append(eng.decode_one([tok])[0])
                        steps.append(eng.prefill(prompt[:9]))
                    runs[name] = steps
                    del eng
                    if name == "kernel":
                        log(f"[path] {model}, {label}: kernel launches "
                            f"{json.dumps({k: v for k, v in build.LAUNCHES.items() if v})}, "
                            f"T=1 attention calls {json.dumps(calls)}")
                        missing = [k for k in must if build.LAUNCHES[k] == 0]
                        check(not missing, f"{model} {label}: kernels never launched: {missing}")
                        want = {k: len(forced) * cfgp.n_layer if k == route else 0 for k in calls}
                        check(calls == want, f"{model} {label}: T=1 attention took {calls}, "
                              f"not the {route} route")
            firsts[label] = runs["kernel"][0]
            for i, (a, b) in enumerate(zip(runs["kernel"], runs["plain"])):
                err = rel_err(torch.from_numpy(a), torch.from_numpy(b))
                what = ("prefill" if i == 0 else "prefill chunk 2" if i == len(forced) + 1
                        else f"decode step {i}")
                what = f"{label}, {what}"
                check(a.shape == (Vp,) and bool(torch.isfinite(torch.from_numpy(a)).all()),
                      f"{model} {what}: logits not finite of shape [{Vp}]")
                log(f"[path] {model}, 2 layers, {what}: logits max rel err {err:.3e} "
                    f"(tol {TOL_PATH:.0e}), argmax kernel {int(a.argmax())} "
                    f"plain {int(b.argmax())}")
                check(err <= TOL_PATH, f"{model}: kernel path disagrees with the plain path "
                      f"at {what}")
        return firsts

    # the dense cache, q8_0 and a split pair; int8 prefill on a 300-token
    # prompt (bucket 512, so the real MMQ_MIN_B of 256 holds); the per-layer
    # decode routes (LLAMACOG_FLASH_STACKED=0): K9 on the dense cache, K8 on q8_0
    cfg2 = llama3_8b_config(n_layer=2)
    p_gpu, p_cpu = two_copies(cfg2)
    prompt20 = [(i * 7919) % V for i in range(2, 22)]
    prompt300 = [(i * 7919) % V for i in range(2, 302)]
    per_layer = {"LLAMACOG_FLASH_STACKED": "0"}
    mmq_label = "LLAMACOG_MMQ=1 300-token prompt"
    firsts = path_check("8B widths", cfg2, p_gpu, p_cpu, [
        ("kv dense", "dense", {}, prompt20, (), "stacked"),
        ("kv q8_0", "q8_0", {}, prompt20, (), "stacked"),
        ("kv q5_1:q4_0", "q5_1:q4_0", {}, prompt20, (), "stacked"),
        (mmq_label, "dense", {"LLAMACOG_MMQ": "1"}, prompt300, ("qmm_i8",), "stacked"),
        ("per-layer dense decode (K9)", "dense", {**per_layer, "LLAMACOG_FLASH_DECODE": "1"},
         prompt20, ("flash_decode",), "per-layer dense"),
        ("per-layer q8_0 decode (K8)", "q8_0", per_layer, prompt20, ("flash_decode_quant",),
         "per-layer quantized"),
    ], [11, 12345, 777, 90000], 1024)
    exact = torch.from_numpy(Engine(p_gpu, cfg2, batch_size=1, max_seq=1024).prefill(prompt300))
    mm = torch.from_numpy(firsts[mmq_label])
    cos = float(torch.nn.functional.cosine_similarity(mm.double(), exact.double(), dim=0))
    log(f"[path] 8B widths, 300-token prompt: cosine of the mmq and the exact prefill logits "
        f"{cos:.6f} (the JAX package's test asks > 0.995 at 512 wide, tests/test_qmm_i8.py:116)")
    del p_gpu, p_cpu, exact, mm
    torch.cuda.empty_cache()
    # Mixtral widths: the 20-token prefill (bucket 32: 64 rows) takes the
    # grouped GEMM, each decode step (2 rows) the gather; max_seq 33 makes
    # the second chunk an exact tail fit of 9 tokens (18 rows: the gather)
    mcfg2 = mixtral_8x7b_config(n_layer=2)
    p_gpu, p_cpu = two_copies(mcfg2)
    path_check("Mixtral widths", mcfg2, p_gpu, p_cpu, [
        ("kv dense", "dense", {}, [(i * 7919) % mcfg.n_vocab for i in range(2, 22)],
         ("qmv_id", "qgemm_id"), "stacked")], [11, 12345, 777, 31000], 33)
    del p_gpu, p_cpu
    torch.cuda.empty_cache()
    log(f"[path] done in {time.perf_counter() - t0:.1f}s")

    # 5. the synthetic Q4_K_M models through the engine
    def main_path_runs(model, params, cfgm, runs):
        """For each run (name, kv type, environment, prompt length, the
        kernels it launches — and no other) in turn (host time drifts within
        a process): TTFT of the prompt, then the counted run, the prompt's
        prefill and N_DECODE greedy tokens, with every kernel's launches.
        Returns per run name the last such run's launches (prefill, decode,
        total) and tokens."""
        Vm = cfgm.n_vocab
        bound_ms = sum_wire_bytes(params, cfgm) / HBM_BYTES_PER_S * 1e3
        out = {}
        for i, (name, kv_type, env, prompt_len, used) in enumerate(runs):
            prompt = [(j * 31337) % Vm for j in range(prompt_len)]
            tag = f"[{model} {name} run {i + 1}]"
            with env_vars(env):
                eng = Engine(params, cfgm, batch_size=1, max_seq=1024, kv_type=kv_type)
                c = eng.cache
                kv_bytes = sum(t.nbytes for t in ((c.k_planes + c.v_planes)
                                                  if isinstance(c, QuantKVCache) else (c.k, c.v)))
                planes = [w for layer in eng.params["layers"] for w in layer.values()
                          if isinstance(w, WireTensor) and w.qi8 is not None]
                if planes:
                    log(f"{tag} int8 prefill planes on {len(planes)} weights: "
                        f"{sum(w.qi8.nbytes + w.ws8T.nbytes for w in planes) / 1e9:.3f} GB")
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
                check(logits.shape == (Vm,)
                      and bool(torch.isfinite(torch.from_numpy(logits)).all()),
                      f"{tag} prefill logits not finite of the expected shape")
                check(toks.shape == (1, N_DECODE) and 0 <= toks.min() and toks.max() < Vm,
                      f"{tag} greedy tokens out of shape or range")
                decode_launches = {k: launches[k] - prefill_launches[k] for k in launches}
                log(f"{tag} KV cache {kv_bytes / 1e6:.1f} MB at max_seq 1024")
                log(f"{tag} TTFT {ttft * 1e3:.2f} ms (median of 3 prefills of {prompt_len} "
                    f"tokens; all: {', '.join(f'{t * 1e3:.2f}' for t in ttfts)} ms)")
                log(f"{tag} decode {N_DECODE} tokens in {dt:.3f}s: {N_DECODE / dt:.2f} "
                    f"tokens/s, {dt / N_DECODE * 1e3:.3f} ms/token; weight-stream bound "
                    f"{bound_ms:.3f} ms/token")
                log(f"{tag} launches: prefill {json.dumps(prefill_launches)}, "
                    f"decode {json.dumps(decode_launches)}")
                log(f"{tag} peak device memory {peak / 2**30:.2f} GiB")
                missing = [k for k in used if launches[k] == 0]
                check(not missing, f"{tag} kernels never launched on the main path: {missing}")
                stray = [k for k in launches if k not in used and launches[k] != 0]
                check(not stray, f"{tag} kernels of another path launched: {stray}")
                out[name] = {"prefill": prefill_launches, "decode": decode_launches,
                             "total": launches, "tokens": toks}
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
            del eng, c, planes
            torch.cuda.empty_cache()
        return out

    def build_params(model, cfgm):
        t0 = time.perf_counter()
        params = make_synthetic_params(cfgm, seed=0)
        torch.cuda.synchronize()
        log(f"[{model}] synthetic Q4_K_M params ({cfgm.n_layer} layers) built in "
            f"{time.perf_counter() - t0:.1f}s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
        if cfgm.n_expert:
            tensors = [params["tok_embd"], params["output"],
                       *(v for layer in params["layers"] for v in layer.values())]
            total = sum(v.nbytes for v in tensors if isinstance(v, WireTensor))
            experts = sum(v.nbytes for v in tensors
                          if isinstance(v, WireTensor) and len(v.shape) == 3)
            stream = sum_wire_bytes(params, cfgm)
            stream_exp = experts * cfgm.n_expert_used // cfgm.n_expert
            log(f"[{model}] wire blocks {total / 1e9:.3f} GB, experts {experts / total:.1%} "
                f"of them; a decode token streams {stream / 1e9:.3f} GB, experts "
                f"{stream_exp / stream:.1%} of it")
        return params

    # the kernels each run launches (and it launches no other)
    dense_attn = ("flash_decode_dense", "flash_prefill")
    quant_attn = ("flash_decode_quant", "flash_prefill_quant")
    moe_kernels = ("qmv_id", "qgemm_id")
    exact_path = ("qmv", "qgemm", *dense_attn)
    mmq_env, k9_env = {"LLAMACOG_MMQ": "1"}, {"LLAMACOG_FLASH_STACKED": "0",
                                              "LLAMACOG_FLASH_DECODE": "1"}
    params = build_params("8b", cfg)
    runs_8b = main_path_runs("8b", params, cfg, [
        ("kv dense", "dense", {}, PROMPT_LEN, exact_path),
        ("kv q8_0", "q8_0", {}, PROMPT_LEN, ("qmv", "qgemm", *quant_attn)),
        ("kv q8_0", "q8_0", {}, PROMPT_LEN, ("qmv", "qgemm", *quant_attn)),
        ("kv dense", "dense", {}, PROMPT_LEN, exact_path),
        # a 512-token prompt, exact and int8 prefill (LLAMACOG_MMQ=1)
        ("exact 512", "dense", {}, 512, exact_path),
        ("mmq 512", "dense", mmq_env, 512, ("qmv", "qmm_i8", *dense_attn)),
        ("mmq 512", "dense", mmq_env, 512, ("qmv", "qmm_i8", *dense_attn)),
        ("exact 512", "dense", {}, 512, exact_path),
        # the per-layer dense decode route (K9)
        ("per-layer K9", "dense", k9_env, PROMPT_LEN, ("qmv", "qgemm", "flash_decode",
                                                       "flash_prefill")),
    ])
    n_l = cfg.n_layer
    mmq_run, k9_run = runs_8b["mmq 512"], runs_8b["per-layer K9"]
    check(mmq_run["prefill"]["qmm_i8"] == 5 * n_l and mmq_run["prefill"]["qgemm"] == 0
          and mmq_run["decode"]["qmm_i8"] == 0,
          f"mmq run: prefill qmm_i8 {mmq_run['prefill']['qmm_i8']} (want {5 * n_l}), qgemm "
          f"{mmq_run['prefill']['qgemm']} (want 0), decode qmm_i8 {mmq_run['decode']['qmm_i8']}")
    check(k9_run["decode"]["flash_decode"] == n_l * N_DECODE
          and k9_run["total"]["flash_decode_dense"] == 0,
          f"K9 run: flash_decode {k9_run['decode']['flash_decode']} (want {n_l * N_DECODE}), "
          f"flash_decode_dense {k9_run['total']['flash_decode_dense']} (want 0)")
    same = bool((k9_run["tokens"] == runs_8b["kv dense"]["tokens"]).all())
    log(f"[8b] per-layer K9 run: {N_DECODE} greedy tokens equal the stacked dense run's: {same}")
    check(same, "the per-layer K9 route's greedy tokens differ from the stacked route's")
    del params
    torch.cuda.empty_cache()
    # Mixtral-8x7B at full depth (28.3 GB of wire blocks), the dense cache:
    # the MoE kernels must launch, the quantized-cache ones must not
    params = build_params("mixtral", mcfg)
    moe_path = (*exact_path, *moe_kernels)
    runs_moe = main_path_runs("mixtral", params, mcfg, [
        ("kv dense", "dense", {}, PROMPT_LEN, moe_path),
        ("kv dense", "dense", {}, PROMPT_LEN, moe_path)])
    del params
    torch.cuda.empty_cache()

    # 6. results
    # each kernel's launches in the run of its path: the MoE kernels in the
    # Mixtral run, the quantized-cache kernels in the 8B q8_0 run, K13 in
    # the mmq run, K9 in the per-layer run, the rest in the 8B dense run
    run_of = {"qmm_i8": mmq_run, "flash_decode": k9_run,
              **{k: runs_moe["kv dense"] for k in moe_kernels},
              **{k: runs_8b["kv q8_0"] for k in quant_attn}}
    for r in results:
        k = r.pop("kernel")
        r["launches"] = run_of.get(k, runs_8b["kv dense"])["total"][k]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in results]}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def sum_wire_bytes(params: dict, cfg) -> int:
    """Bytes one decode step must stream: every layer weight, n_expert_used
    of the n_expert experts of each stacked expert tensor, and the LM head
    (the embedding table is gathered by row, not streamed)."""
    from llamacog_tpu_torch.quant.wire import WireTensor

    total = params["output"].nbytes
    for layer in params["layers"]:
        for v in layer.values():
            if isinstance(v, WireTensor):
                total += (v.nbytes * cfg.n_expert_used // cfg.n_expert if len(v.shape) == 3
                          else v.nbytes)
    return total


if __name__ == "__main__":
    sys.exit(main())
