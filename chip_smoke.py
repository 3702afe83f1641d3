#!/usr/bin/env python3
"""Smoke test of the PyTorch port (llamacog_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. environment: torch, CUDA, nvcc, the card's name and power limit;
  2. build every CUDA kernel from llamacog_tpu_torch/csrc (one nvcc per
     source, in parallel) into llamacog_tpu_torch/csrc/build/;
  3. each kernel against its plain PyTorch version at the Llama-3-8B shapes
     of the main path, with kernel, plain, library and bound times: the
     weight kernels (qmv at one row, qgemm at 128 and 512 rows; also over
     the Q8_0 and Q5_K weights of a real Mixtral Q4_K_M file and its
     attn_q + attn_k + attn_v launch; and every kind of llama.cpp's other
     presets, Q4_0, Q4_1, Q5_0, Q5_1, Q2_K, Q3_K, the codebook IQ4_NL,
     IQ4_XS, IQ3_XXS, IQ3_S, IQ2_S, IQ2_XXS, IQ2_XS, IQ1_S, IQ1_M and the
     ternary TQ1_0, TQ2_0, at gate_up and ffn_down (the last six also at
     8 rows), with a Q3_K_M layer's Q3_K attn_qk + Q5_K attn_v launch, an
     IQ3_XXS layer's IQ2_S + Q4_K, an IQ4_XS layer's IQ4_XS + Q5_K, the
     1-bit and 2-bit presets' attn_qk + Q4_K attn_v and an 8-expert
     ternary file's TQ attn_q + Q8_0 attn_k + attn_v; qmv at one row and
     qgemm at 128 also at Llama-3-70B IQ2_XXS's own weights, K up to
     28672), the int8 route's activation
     quantization (bit-equal) and prefill GEMM (K13, bit-equal at both tile
     heights, beside torch._int_mm) at the five layer shapes at 512 rows and
     ragged 300, and attn_qk + attn_v on one quantization; the dense-cache
     attention kernels (the
     stacked K4 and the per-layer K9 at depths 1000 and 32765; prefill K5
     at T=128 over write offsets 0 and 896 and at T=512; K4 and K5 also at
     Llama-3-70B's heads, 64 query heads over 8 kv heads; each also run once
     with host syncs raising, and timed beside SDPA on the device alone and
     on the host per call; K5's bf16 SIMT body at head dim 72 and on a
     misaligned cache view), and the quantized-cache attention
     kernels (decode over every K/V kind pair at depth 1000, q8_0/q4_0 at
     depth 32765, the per-layer entries; prefill K7's tensor-core tiles
     over every kind pair at T=128 from write offset 896, three of them
     also from 0, and q8_0/q4_0 at T=2048 from offsets 0 and 2048 of a
     4096-slot layer, each beside K5 over a dense cache of the same values;
     K7's SIMT body in f32 and on a q off 16 bytes); then the MoE kernels
     at the Mixtral-8x7B expert shapes (the
     gather at 2 and 32 rows, the offset entry, the grouped GEMM of a
     128- and a 512-token prefill; both again over gate_up and down stacks
     of every other kind: Q8_0, Q5_K and the seventeen above, the last six
     also through the offset entry); and the shapes of a 4-slot serving
     step: qmv at 4 rows on the 8B weights, K4 and K6 (q8_0) over 4 rows
     at depths 0, 100, 1000 and 2047, K5 and K7 on a one-row view of a
     4-row cache;
  4. the full-width kernel path (8B widths, 2 layers) against the plain
     path (the same params on the CPU): prefill logits, 4 teacher-forced
     decode steps (Engine.decode_one: replays of the step's CUDA graph on
     the card, the same step run eagerly on the CPU) and a 9-token second
     chunk, with the dense cache, q8_0,
     the split q5_1:q4_0 cache, LLAMACOG_MMQ=1 on a 300-token prompt (int8
     prefill), and the per-layer decode routes (LLAMACOG_FLASH_STACKED=0:
     K9 on the dense cache with LLAMACOG_FLASH_DECODE=1, K8 on q8_0), and
     the presets Q4_0 (with LLAMACOG_MMQ=1), Q5_1, Q3_K_M, Q2_K, IQ4_XS,
     IQ3_XXS and IQ1_M; then the same at Mixtral widths (2 layers, dense
     cache, the attention weight kinds of a real Q4_K_M file: Q8_0
     attn_k/attn_v, Q5_K attn_output): a 20-token prefill (grouped GEMM), 4
     decode steps and a 9-token second chunk (gather), and the presets
     Q5_K_M, Q3_K_M, IQ2_M, IQ3_XXS (an f32 model: see phase 4's comment)
     and TQ1_0 (the CPU copy keeps each weight's plain dequant, made on the
     card: wire.keep_decoded's form); and a 4-row engine (8B widths, dense
     and q8_0; Mixtral widths, dense): row prefills of 20, 9 and 33 tokens,
     decode steps with inactive rows, a shift_row, each row of the bf16
     model held against single-stream engines on the card, and the kernel
     path against the plain path (the 8B as an f32 model);
  5. whether stream capture keeps the split-S combine's programmatic
     dependent launch (K4 and K6 captured alone: the graph's edges by
     type, the replay against the eager call), then the 8B Q4_K_M
     synthetic run through Engine at full depth, every decode through the
     step's CUDA graph (captured before the counted run; the decode's
     launches must be the captured ones times the replays), in turns:
     the dense cache and kv_type="q8_0" (dense, q8_0, q8_0, dense;
     128-token prefill, 128 greedy tokens), a 512-token prompt exact and
     with LLAMACOG_MMQ=1 (exact, mmq, mmq, exact), and the per-layer dense
     decode route (K9), whose greedy tokens must equal the stacked
     route's (the mmq runs quantize each layer input once: 4 launches a
     layer), a long-context run (max_seq 8192, a 4096-token prompt in
     two 2048-token chunks, 64 greedy tokens) and two deep q8_0 runs
     (max_seq 4096, a 2048-token prompt in one chunk, 64 greedy tokens at
     depth 2048-2112; max_seq 8192, a 4096-token prompt in two chunks, 16
     tokens); every kernel's launch count over each run; the first dense,
     q8_0 and Mixtral 128-token runs also decode eagerly, the same engine
     step called from Python every token, in turns with the graph (graph,
     eager, eager, graph; the tokens must be equal), with ms/token of both;
     one sampled loop (SamplerChain with a fixed seed, 32 tokens through
     decode_one), run twice, must draw the same tokens; then, with the
     8B params freed, the Mixtral-8x7B Q4_K_M synthetic run at full depth
     (32 layers, the kinds of a real file), the same way, and with a
     512-token prompt and 16 tokens (the grouped GEMM over several tiles an
     expert); then the other presets, each with a 128-token prompt and 64
     greedy tokens through the graph: the 8B at full depth in Q4_0, Q4_1,
     Q5_0, Q5_1, Q2_K, Q3_K_M, IQ4_XS, IQ4_NL, IQ3_XXS, IQ3_M, IQ2_M,
     IQ2_XXS, IQ2_S, IQ1_S, IQ1_M, TQ1_0 and TQ2_0, Mixtral-8x7B Q5_K_M and
     IQ4_XS at full depth, and Mixtral in Q8_0, Q4_0, Q4_1, Q5_0, Q5_1,
     Q2_K, IQ4_NL, IQ3_XXS, IQ3_S, IQ2_M, IQ2_XXS, IQ2_S, IQ1_S, IQ1_M,
     TQ1_0 and TQ2_0 at MIXTRAL_PRESET_LAYERS layers (one preset for each
     other expert kind); then Llama-3-70B IQ2_XXS at full depth (80 layers,
     the preset that puts a 70B on one card); after the 8B runs, the
     serving run (the port's server over HTTP, 4 slots, ctx 4096, 8
     requests at once from --seed: greedy held against single-stream
     engines, seeded sent twice, a JSON schema, a streamed stop string;
     then one request past a 512-token context on one slot, dense and
     q8_0; every decode step a graph replay); the phase's wall time;
  6. each phase's seconds, one JSON line of per-kernel results, the card's
     name and power limit, and the final {"ok": true, ...} line.

Weights are random wire blocks made on the card from a seed, each tensor of
the kind llama.cpp's rules give it under the run's preset (Q4_K_M unless
named; utils/synthetic.py; the IQ presets with an importance matrix, as the
public files are made).
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12          # H100 SXM f32 outside the tensor cores
INT8_OPS = 1979e12         # H100 SXM dense int8 tensor-core peak
# tolerances, relative to the largest |reference| value
# qmm: qmv rounds no value to a narrower type but sums in another order
# than the plain version: the biased levels (16 + q, 64 + q, exact f32)
# dotted with x in f32 FMAs per part of a sub-block, the scale applied
# after, the offset and the bias folded against the part's sum of x (the
# TPU kernel's order). qgemm forms
# every weight bit for bit as the plain version and
# rounds it to bf16 as it does; only the f32 summation order differs. Over
# K <= 28672 terms (the 70B's ffn_down) the worst case is ~K * 2^-24 of the
# term magnitudes (1.7e-3); the folded order run in plain f32 at the 8B
# widths stays far inside the tolerance (tests/test_torch_qmm.py)
TOL_QMM = 1e-4
# qmm_i8: the same integer block products and the same f32 combine,
# operation for operation, as the plain version: bit parity expected
TOL_K13 = 1e-6
TOL_ATTN = 1e-2       # bf16 outputs: one bf16 rounding (2^-8) of each side
TOL_PATH = 5e-2       # bf16 model, 2 layers: bf16 roundings that flip between paths
# a row of a B-row engine against a single-stream engine fed the row's own
# calls, on the card: the same kernels at the same shapes, a row's qmv and
# attention independent of the others' (at these depths one split of the
# decode attention is live whatever the split count)
TOL_ROWS = 1e-6
# a router tie: the k-th and the (k+1)-th router logits of a row within this
# many bf16 ulps of the k-th (the bf16 roundings of the layer input that
# differ between the two paths move a logit by about one)
TIE_ULPS = 2
PROMPT_LEN = 128
N_DECODE = 128
N_SERVE = 64  # tokens a serving request generates
SEED = 0      # --seed: the serving run's prompts
# the weight kinds of llama.cpp's presets beside Q4_K_M's, and the preset
# whose phase-5 run holds each (in the 8B dense weights; in the Mixtral
# expert stacks, EXPERT_PRESET)
NEW_KINDS = ("Q4_0", "Q4_1", "Q5_0", "Q5_1", "Q2_K", "Q3_K")
# the 1-2 bit kinds of llama.cpp's IQ2 and IQ1 presets and the ternary
# ones (quant/wire.py::LOW_BIT_KINDS), each the body of the preset of
# LOW_PRESET (the preset IQ2_S's body is IQ2_XS)
LOW_PRESET = {"IQ2_XXS": "IQ2_XXS", "IQ2_XS": "IQ2_S", "IQ1_S": "IQ1_S", "IQ1_M": "IQ1_M",
              "TQ1_0": "TQ1_0", "TQ2_0": "TQ2_0"}
KIND_PRESET = {"Q4_0": "Q4_0", "Q4_1": "Q4_1", "Q5_0": "Q5_0", "Q5_1": "Q5_1", "Q2_K": "Q2_K",
               "Q3_K": "Q3_K_M", "IQ4_NL": "IQ4_NL", "IQ4_XS": "IQ4_XS", "IQ3_XXS": "IQ3_XXS",
               "IQ3_S": "IQ3_M", "IQ2_S": "IQ2_M", **LOW_PRESET}
EXPERT_PRESET = {"Q8_0": "Q8_0", "Q5_K": "Q5_K_M", "Q4_0": "Q4_0", "Q4_1": "Q4_1",
                 "Q5_0": "Q5_0", "Q5_1": "Q5_1", "Q2_K": "Q2_K", "Q3_K": "Q2_K",
                 "IQ4_NL": "IQ4_NL", "IQ4_XS": "IQ4_XS", "IQ3_XXS": "IQ3_XXS", "IQ3_S": "IQ3_S",
                 "IQ2_S": "IQ2_M", **LOW_PRESET}
# the Mixtral preset runs at full depth; the others (each holds one more
# expert kind) at MIXTRAL_PRESET_LAYERS layers
MIXTRAL_FULL_DEPTH = ("Q5_K_M", "IQ4_XS")
MIXTRAL_PRESET_LAYERS = 4
LONG_PROMPT = 4096
# the serving run of phase 5: slots, and the depths of the B-row attention
# cases of phase 3 (a row at depth 0, rows at their own depths)
SERVING_SLOTS = 4
SERVING_DEPTHS = (0, 100, 1000, 2047)
# phase-5 runs whose decode also runs eagerly, in turns with the graph
EAGER_TURNS = {("8b", "kv dense"), ("8b", "kv q8_0"), ("mixtral", "kv dense")}


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
    import numpy as np
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
    from llamacog_tpu_torch.models import llama as llama_mod
    from llamacog_tpu_torch.models.llama import _ffn_moe, moe_sort
    from llamacog_tpu_torch.ops.linear import qmatmul
    from llamacog_tpu_torch.ops.cuda.qmm import qgemm, qmm_plain, qmv
    from llamacog_tpu_torch.ops.cuda.qmm_i8 import (
        qmm_i8_kernel, qmm_i8_plain, qmm_i8_tile_rows, quantize_activations, quantize_kernel)
    from llamacog_tpu_torch.ops.cuda.qmm_id import (
        RAGGED_TILE, qmm_gather, qmm_gather_offset, qmm_gather_plain, qmm_ragged,
        qmm_ragged_plain)
    from llamacog_tpu_torch.ops.linear import qmatmul_multi
    from llamacog_tpu_torch.quant.mmq import build_mmq_planes
    from llamacog_tpu_torch.quant.wire import CODEBOOK_KINDS, LOW_BIT_KINDS, WireTensor, dequantize
    from llamacog_tpu_torch.runtime.engine import Engine
    from llamacog_tpu_torch.runtime.kv_cache import (
        QuantKVCache, kv_dequant_planes, kv_plane_shapes)
    from llamacog_tpu_torch.runtime.sampler import SamplerChain, SamplerParams
    from llamacog_tpu_torch.utils.synthetic import (
        CODEBOOK_PRESETS, DEFAULT_LAYOUT, llama3_70b_config, llama3_8b_config,
        make_synthetic_params, mixtral_8x7b_config, random_experts, random_wire)

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
    phase_s = {"build": time.perf_counter() - t0}
    log(f"[build] {phase_s['build']:.1f}s wall, per source "
        + json.dumps({k: round(v, 1) for k, v in secs.items()}))
    for name, text in build.BUILD_LOG.items():
        func = "?"
        for line in text.splitlines():
            if "Compiling entry function" in line:
                func = line.split("'")[1] if "'" in line else line.strip()
            elif "registers" in line or "spill" in line:
                log(f"[build] {name} {func}: {line.strip()}")

    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=dev)

    def flush_l2(hold=False):
        """Flush the L2 cache by rewriting a 256 MB buffer (untimed). With
        hold, keep the card busy ~0.2 ms more, so that the host has queued
        the timed call before the start event fires."""
        flush.zero_()
        if hold:
            torch.cuda._sleep(400_000)

    def time_ms(fn, iters=15, warmup=2, hold=False) -> float:
        """Median time of one call (CUDA events), L2 flushed before each
        call. The span starts right after the flush, so a wrapper's host work
        that outlasts the flush counts: the span of every `ms` in the results.
        With hold, the device's time alone (flush_l2)."""
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            flush_l2(hold)
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    def time_interleaved_ms(fns, iters=31, warmup=2, hold=False) -> list:
        """time_ms of each of fns, the calls taken in turns within one loop
        so that a drift of the card's clocks reaches all of them alike.
        Logs each one's spread (min-max)."""
        for _ in range(warmup):
            for fn in fns:
                fn()
        times = [[] for _ in fns]
        for _ in range(iters):
            for fn, t in zip(fns, times):
                flush_l2(hold)
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                fn()
                b.record()
                torch.cuda.synchronize()
                t.append(a.elapsed_time(b))
        log(f"[timing] interleaved{' (device alone)' if hold else ''}: " + ", ".join(
            f"median {statistics.median(t):.4f} ms (min {min(t):.4f}, max {max(t):.4f})"
            for t in times))
        return [statistics.median(t) for t in times]

    def host_us(fn, n=200) -> float:
        """Host time of one call (the wrapper's Python and launches), the
        device's drain excluded."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        dt = time.perf_counter() - t0
        torch.cuda.synchronize()
        return dt / n * 1e6

    def log_device_and_host(what, named):
        """Log each (name, fn)'s device time alone (in turns) and its host
        time per call."""
        dev_ms = time_interleaved_ms([fn for _, fn in named], hold=True)
        log(f"[timing] {what}: " + ", ".join(
            f"{name} device {d:.4f} ms, host {host_us(fn):.1f} us a call"
            for (name, fn), d in zip(named, dev_ms)))

    results = []
    # phase 4's 4-row engines' bf16 launches, for the rows of the shapes no
    # phase-5 run drives
    rows_runs = {}

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
               library_ms=None, peak=BF16_FLOPS, counter=None, listed=True, run=None):
        """Hold a kernel's outputs against its plain version's (relative to
        the largest |reference|, tolerance `tol`) and keep its times. The
        bound is the larger of nbytes over the HBM rate and flops over
        `peak` (the tensor-core rate of the operands' type); `counter` is
        the launch count the row reads (the source's name by default), in
        the run `run` ("mixtral", a phase-5 8B run's name or a phase-4
        4-row engine's, rows_runs; by default
        the run of the kernel's path). A
        row that is not `listed` is checked and logged but left out of the
        results line: no run of phase 5 launches its kernel."""
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
        if listed:
                results.append({"name": name, "route": "cuda", "source": source,
                            "replaces": replaces,
                            "kernel": counter or source.split("/")[-1][:-3], "run": run,
                            "max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
                            "bound_ms": bound, "bound_by": by, "library_ms": library_ms})

    # 3. per-kernel parity at the 8B shapes
    t3 = time.perf_counter()
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
    # the attention weights of a real Mixtral-8x7B Q4_K_M file (8 experts:
    # Q8_0 attn_k/attn_v, Q5_K attn_output; attn_q Q4_K), at its widths
    w_q4 = random_wire("Q4_K", E, E, g, dev)
    w_k8 = random_wire("Q8_0", 1024, E, g, dev)
    w_v8 = random_wire("Q8_0", 1024, E, g, dev)
    w_o5 = random_wire("Q5_K", E, E, g, dev)
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
              ("output Q6_K 128256x4096", [w_head], False),
              ("attn_k Q8_0 1024x4096", [w_k8], False),
              ("attn_output Q5_K 4096x4096", [w_o5], False),
              ("Mixtral attn_q+attn_k+attn_v Q4_K 4096x4096 + Q8_0 1024x4096 x2",
               [w_q4, w_k8, w_v8], True)]
    def weight_parity(kname, fn, B, label, ws, multi, run):
        """qmv or qgemm at B rows of x over the weights ws (one launch),
        held against qmm_plain; the launches read from the phase-5 run `run`."""
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
               nbytes, flops, run=run)

    # qgemm at the 128-token prompt and at a 512-row prefill chunk (the route
    # K13 replaces with LLAMACOG_MMQ=1)
    weight_calls = (("qmv", qmv, 1), ("qgemm", qgemm, PROMPT_LEN), ("qgemm", qgemm, 512))
    for kname, fn, B in weight_calls:
        for label, ws, multi in shapes:
            if kname == "qgemm" and label.startswith("output"):
                continue  # the prefill LM head runs on the last position only: qmv
            # the Q8_0 and Q5_K weights run on the Mixtral path: its run's launches
            mixtral_kinds = any(w.kind in ("Q8_0", "Q5_K") for w in ws)
            weight_parity(kname, fn, B, label, ws, multi, "mixtral" if mixtral_kinds else None)
    # qmv at B = 4, one row a server slot (the serving run's decode steps), on
    # the 8B Q4_K_M weights: K1 alone and the attn_qk + attn_v launch (K3)
    for label, ws, multi in shapes:
        if not any(w.kind in ("Q8_0", "Q5_K") for w in ws):
            weight_parity("qmv", qmv, SERVING_SLOTS, label, ws, multi, "serving")
    # the legacy, low-bit and codebook kinds of llama.cpp's other presets at
    # the 8B FFN shapes, each read in the phase-5 run of a preset that holds
    # it; and the mixed launches of a Q3_K_M layer's attn_qk (Q3_K) + attn_v
    # (Q5_K, layers 0-1), an IQ3_XXS (and IQ2_M) layer's IQ2_S attn_qk + Q4_K
    # attn_v and an IQ4_XS layer's IQ4_XS attn_qk + Q5_K attn_v
    for kind in (*NEW_KINDS, *CODEBOOK_KINDS, *LOW_BIT_KINDS):
        w_gu_k, w_d_k = random_wire(kind, 2 * F, E, g, dev), random_wire(kind, E, F, g, dev)
        calls = weight_calls if kind not in LOW_BIT_KINDS else (
            weight_calls[:1] + (("qmv", qmv, 8),) + weight_calls[1:])
        for kname, fn, B in calls:
            for label, w in ((f"ffn_gate_up {kind} 28672x4096", w_gu_k),
                             (f"ffn_down {kind} 4096x14336", w_d_k)):
                weight_parity(kname, fn, B, label, [w], False, f"8b {KIND_PRESET[kind]}")
        del w_gu_k, w_d_k
    for preset, qk, v in (("Q3_K_M", "Q3_K", "Q5_K"), ("IQ3_XXS", "IQ2_S", "Q4_K"),
                          ("IQ4_XS", "IQ4_XS", "Q5_K"), ("IQ2_XXS", "IQ2_XXS", "Q4_K"),
                          ("IQ2_S", "IQ2_XS", "Q4_K"), ("IQ1_S", "IQ1_S", "Q4_K"),
                          ("IQ1_M", "IQ1_M", "Q4_K")):
        w_qk_p, w_v_p = random_wire(qk, 5120, E, g, dev), random_wire(v, 1024, E, g, dev)
        for kname, fn, B in weight_calls:
            weight_parity(kname, fn, B, f"{preset} attn_qk+attn_v {qk} 5120x4096 + {v} 1024x4096",
                          [w_qk_p, w_v_p], True, f"8b {preset}")
        del w_qk_p, w_v_p
    # an 8-expert ternary file's attn_q + attn_k + attn_v (TQ + Q8_0 + Q8_0:
    # the K3 launch of the Mixtral TQ runs; the dense ternary files fuse q+k+v)
    for preset in ("TQ1_0", "TQ2_0"):
        ws_p = [random_wire(preset, E, E, g, dev), random_wire("Q8_0", 1024, E, g, dev),
                random_wire("Q8_0", 1024, E, g, dev)]
        for kname, fn, B in weight_calls:
            weight_parity(kname, fn, B, f"Mixtral {preset} attn_q+attn_k+attn_v {preset} "
                          "4096x4096 + Q8_0 1024x4096 x2", ws_p, True, f"mixtral {preset}")
        del ws_p
    # Llama-3-70B IQ2_XXS's own weights, read in its phase-5 run: K up to
    # 28672, twice any K above (its IQ2_XXS ffn_down and layers 0-9's Q2_K
    # one), its IQ2_XXS attn_qk + Q4_K attn_v launch and attn_output at K
    # 8192, its gate_up, and the Q5_K LM head (qmv only, as above)
    c70 = llama3_70b_config()
    E70, F70, hd70 = c70.n_embd, c70.n_ff, c70.head_dim_k
    for label, shapes70 in (
            (f"attn_qk+attn_v IQ2_XXS {(c70.n_head + c70.n_head_kv) * hd70}x{E70} + Q4_K "
             f"{c70.n_head_kv * hd70}x{E70}",
             (("IQ2_XXS", (c70.n_head + c70.n_head_kv) * hd70, E70),
              ("Q4_K", c70.n_head_kv * hd70, E70))),
            (f"attn_output IQ2_XXS {E70}x{E70}", (("IQ2_XXS", E70, E70),)),
            (f"ffn_gate_up IQ2_XXS {2 * F70}x{E70}", (("IQ2_XXS", 2 * F70, E70),)),
            (f"ffn_down IQ2_XXS {E70}x{F70}", (("IQ2_XXS", E70, F70),)),
            (f"ffn_down Q2_K {E70}x{F70}", (("Q2_K", E70, F70),)),
            (f"output Q5_K {c70.n_vocab}x{E70}", (("Q5_K", c70.n_vocab, E70),))):
        ws70 = [random_wire(kind, n, k, g, dev) for kind, n, k in shapes70]
        for kname, fn, B in weight_calls[:1 if label.startswith("output") else 2]:
            weight_parity(kname, fn, B, f"70b {label}", ws70, len(ws70) > 1, "70b IQ2_XXS")
        del ws70
        torch.cuda.empty_cache()

    # the activation quantization of the int8 route (one launch a layer
    # input), bit-equal to its plain version, at the 8B layer inputs: a
    # 512-row prefill chunk and a ragged 300, K 4096 (attention, FFN input)
    # and 14336 (ffn_down's), with a row of zeros and ties to round
    i8_rep = "llamacog_tpu/ops/pallas/qmm_i8.py:{}"
    log("[parity] quantize_i8: no single PyTorch call quantizes per row (library_ms null)")
    for B, K in ((512, E), (512, F), (300, E)):
        x = torch.randn(B, K, generator=g, device=dev).to(torch.bfloat16) * 3
        x[1] = 0
        x[2, :4] = torch.tensor([127.0, 63.5, -0.5, 1.5], device=dev).to(torch.bfloat16)
        xq, xs = quantize_kernel(x)
        rq, rs = quantize_activations(x)
        torch.cuda.synchronize()
        check(torch.equal(xq, rq) and torch.equal(xs, rs),
              f"quantize_i8 B={B} K={K}: not bit-equal to quantize_activations")
        record(f"quantize_i8 B={B} K={K} bf16", qmm_src.format("qmm_i8"), i8_rep.format(105),
               [xq.float(), xs], [rq.float(), rs], 0.0, time_ms(lambda: quantize_kernel(x)),
               time_ms(lambda: quantize_activations(x), iters=5),
               x.numel() * 2 + xq.numel() + xs.numel() * 4, 0, counter="quantize_i8",
               run="mmq 512")

    # the int8 prefill GEMM (K13, LLAMACOG_MMQ=1) over the planes of the five
    # 8B layer weights, at a 512-row prefill chunk and a ragged 300, with each
    # tile height the grid rule does not take beside it in the log
    log("[parity] qmm_i8: the library time is torch._int_mm(xq, qi8.T), the int32 "
        "products alone, without the per-block weight scales and the row scales; "
        "qmatmul's int8 route runs each shape once with host syncs raising")
    i8_shapes = [("attn_qk Q4_K 5120x4096", w_qk), ("attn_v Q6_K 1024x4096", w_v),
                 ("attn_output Q4_K 4096x4096", w_o), ("ffn_gate_up Q4_K 28672x4096", w_gu),
                 ("ffn_down Q4_K 4096x14336", w_d4)]
    for label, w in i8_shapes:
        qi8, ws8T = build_mmq_planes(w)
        N, K = w.shape
        w8 = WireTensor(w.kind, w.shape, w.blocks, qi8, ws8T)
        for B in (512, 300):
            x = torch.randn(B, K, generator=g, device=dev).to(torch.bfloat16)
            xq, xs = quantize_activations(x)
            rule = qmm_i8_tile_rows(B, N)
            other = 192 - rule
            out = qmm_i8_kernel(xq, xs, qi8, ws8T)
            ref = qmm_i8_plain(xq, xs, qi8, ws8T)
            torch.cuda.synchronize()
            check(torch.equal(qmm_i8_kernel(xq, xs, qi8, ws8T, tile_rows=other), ref),
                  f"qmm_i8 B={B} {label}: {other}-row tiles disagree with qmm_i8_plain")
            log_device_and_host(f"qmm_i8 B={B} {label}", [
                (f"K13 {rule}-row tiles (the rule)", lambda: qmm_i8_kernel(xq, xs, qi8, ws8T)),
                (f"K13 {other}-row tiles", lambda: qmm_i8_kernel(xq, xs, qi8, ws8T,
                                                                 tile_rows=other)),
                ("torch._int_mm", lambda: torch._int_mm(xq, qi8.t()))])
            record(f"qmm_i8 B={B} {label}", qmm_src.format("qmm_i8"), i8_rep.format(68),
                   [out], [ref], TOL_K13,
                   time_ms(lambda: qmm_i8_kernel(xq, xs, qi8, ws8T)),
                   time_ms(lambda: qmm_i8_plain(xq, xs, qi8, ws8T), iters=5),
                   xq.numel() + xs.numel() * 4 + qi8.numel() + ws8T.numel() * 4
                   + out.numel() * 4, 2 * B * N * K,
                   time_ms(lambda: torch._int_mm(xq, qi8.t())), peak=INT8_OPS)
            # the model's int8 route (one quantization, then K13) never makes
            # the host wait for the card
            check(torch.equal(no_sync(lambda: qmatmul(x, w8)), ref.to(torch.bfloat16)),
                  f"qmatmul {label}: the int8 route disagrees with qmm_i8_plain")
            del out, ref
        del qi8, ws8T, w8
    # attn_qk and attn_v share one quantization of the layer input
    w8s = [WireTensor(w.kind, w.shape, w.blocks, *build_mmq_planes(w)) for w in (w_qk, w_v)]
    x = torch.randn(512, E, generator=g, device=dev).to(torch.bfloat16)
    before = dict(build.LAUNCHES)
    outs = no_sync(lambda: qmatmul_multi(x, w8s))
    took = {k: c - before[k] for k, c in build.LAUNCHES.items() if c != before[k]}
    check(took == {"quantize_i8": 1, "qmm_i8": 2}
          and all(torch.equal(o, qmatmul(x, w8)) for o, w8 in zip(outs, w8s)),
          f"qmatmul_multi attn_qk+attn_v int8: launched {took}, not one quantization and "
          f"two K13, or results not those of per-weight qmatmul")
    log("[parity] qmatmul_multi attn_qk+attn_v, int8: one quantize_i8 launch and two qmm_i8, "
        "results equal per-weight qmatmul")
    del w8s, outs

    H, Hkv, D = cfg.n_head, cfg.n_head_kv, cfg.head_dim_k
    rep = H // Hkv
    scale = D ** -0.5
    S = 1024

    def rnd(*s):
        return torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)

    # decode attention: layer 1 of a 2-layer stacked cache, at depth 1000 of
    # 1024 slots and 32765 of 32768
    q, kc, vc = rnd(1, H, D), rnd(1, Hkv, D), rnd(1, Hkv, D)
    qf = q[:, :, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for S_dec, n in ((S, 1000), (32768, 32765)):
        ks, vs = rnd(2, 1, S_dec, Hkv, D), rnd(2, 1, S_dec, Hkv, D)
        seq = torch.tensor([n], dtype=torch.int32, device=dev)
        out = flash_decode_stacked_dense(q, ks, vs, 1, kc, vc, seq, scale)
        ref = flash_decode_stacked_dense_plain(q, ks, vs, 1, kc, vc, seq, scale)
        kf = torch.cat([ks[1, :, :n], kc[:, None]], 1).transpose(1, 2).contiguous()
        vf = torch.cat([vs[1, :, :n], vc[:, None]], 1).transpose(1, 2).contiguous()
        lib = sdpa(qf, kf, vf, scale=scale, enable_gqa=True)[:, :, 0]
        torch.cuda.synchronize()
        log(f"[library] decode seq_len={n} sdpa vs plain: max rel err {rel_err(lib, ref):.3e}")
        for fn in (lambda: flash_decode_stacked_dense(q, ks, vs, 1, kc, vc, seq, scale),
                   lambda: flash_decode_kernel(q, ks[1], vs[1], kc, vc, seq, scale)):
            no_sync(fn)
        log(f"[sync] K4 and K9 at seq_len={n} ran with host syncs raising")
        # K4 and the per-layer K9 below launch one kernel on the same layer:
        # they are timed in turns, K4 first
        log(f"[timing] K4 (stacked) and K9 (per-layer) on layer 1, seq_len={n}:")
        k4_ms, k9_ms = time_interleaved_ms(
            [lambda: flash_decode_stacked_dense(q, ks, vs, 1, kc, vc, seq, scale),
             lambda: flash_decode_kernel(q, ks[1], vs[1], kc, vc, seq, scale)])
        dec_bytes = 2 * (q.numel() + 2 * n * Hkv * D + kc.numel() + vc.numel() + H * D)
        sdpa_ms = time_ms(lambda: sdpa(qf, kf, vf, scale=scale, enable_gqa=True))
        log_device_and_host(f"decode seq_len={n}", [
            ("K4", lambda: flash_decode_stacked_dense(q, ks, vs, 1, kc, vc, seq, scale)),
            ("K9", lambda: flash_decode_kernel(q, ks[1], vs[1], kc, vc, seq, scale)),
            ("sdpa", lambda: sdpa(qf, kf, vf, scale=scale, enable_gqa=True))])
        record(f"flash_decode_dense H={H} Hkv={Hkv} D={D} S={S_dec} seq_len={n}",
               "llamacog_tpu_torch/csrc/flash_decode_dense.cu",
               "llamacog_tpu/ops/pallas/flash_q8.py:968", [out], [ref], TOL_ATTN, k4_ms,
               time_ms(lambda: flash_decode_stacked_dense_plain(q, ks, vs, 1, kc, vc, seq,
                                                                scale), iters=5),
               dec_bytes, 4 * H * (n + 1) * D, sdpa_ms)
        # the per-layer entry (K9, LLAMACOG_FLASH_STACKED=0 LLAMACOG_FLASH_DECODE=1)
        # on the same layer as one [B, S, Hkv, D] tensor
        out = flash_decode_kernel(q, ks[1], vs[1], kc, vc, seq, scale)
        ref = flash_decode_attention_plain(q, ks[1], vs[1], kc, vc, seq, scale)
        torch.cuda.synchronize()
        record(f"flash_decode H={H} Hkv={Hkv} D={D} S={S_dec} seq_len={n}",
               "llamacog_tpu_torch/csrc/flash_decode_dense.cu",
               "llamacog_tpu/ops/pallas/flash_decode.py:84", [out], [ref], TOL_ATTN, k9_ms,
               time_ms(lambda: flash_decode_attention_plain(q, ks[1], vs[1], kc, vc, seq,
                                                            scale), iters=5),
               dec_bytes, 4 * H * (n + 1) * D, sdpa_ms, counter="flash_decode")
        del ks, vs, kf, vf
        torch.cuda.empty_cache()

    # a serving step: B = 4 rows of a 2048-slot cache at their own depths,
    # one at depth 0 (SERVING_DEPTHS), layer 1 of 2; SDPA over the same rows
    # with a per-row mask as the library call
    nb = SERVING_SLOTS
    depths = torch.tensor(SERVING_DEPTHS, dtype=torch.int32, device=dev)
    qb, kcb, vcb = rnd(nb, H, D), rnd(nb, Hkv, D), rnd(nb, Hkv, D)
    ksb, vsb = rnd(2, nb, 2048, Hkv, D), rnd(2, nb, 2048, Hkv, D)
    args = (qb, ksb, vsb, 1, kcb, vcb, depths, scale)
    out = flash_decode_stacked_dense(*args)
    ref = flash_decode_stacked_dense_plain(*args)
    kf = torch.cat([ksb[1], kcb[:, None]], 1).transpose(1, 2).contiguous()
    vf = torch.cat([vsb[1], vcb[:, None]], 1).transpose(1, 2).contiguous()
    pos = torch.arange(2049, device=dev)
    allowed = ((pos[None, :] < depths[:, None].long()) | (pos[None, :] == 2048))[:, None, None]
    lib = sdpa(qb[:, :, None], kf, vf, attn_mask=allowed, scale=scale, enable_gqa=True)[:, :, 0]
    torch.cuda.synchronize()
    log(f"[library] decode B={nb} seq_len={SERVING_DEPTHS} sdpa vs plain: max rel err "
        f"{rel_err(lib, ref):.3e}")
    keys = sum(n + 1 for n in SERVING_DEPTHS)
    record(f"flash_decode_dense B={nb} H={H} Hkv={Hkv} D={D} S=2048 seq_len="
           + "/".join(map(str, SERVING_DEPTHS)),
           "llamacog_tpu_torch/csrc/flash_decode_dense.cu",
           "llamacog_tpu/ops/pallas/flash_q8.py:968", [out], [ref], TOL_ATTN,
           time_ms(lambda: flash_decode_stacked_dense(*args)),
           time_ms(lambda: flash_decode_stacked_dense_plain(*args), iters=5),
           2 * (qb.numel() + 2 * sum(SERVING_DEPTHS) * Hkv * D + kcb.numel() + vcb.numel()
                + nb * H * D), 4 * H * keys * D,
           time_ms(lambda: sdpa(qb[:, :, None], kf, vf, attn_mask=allowed, scale=scale,
                                enable_gqa=True)), run="serving")
    del ksb, vsb, kf, vf, allowed, lib, args
    torch.cuda.empty_cache()

    # prefill attention over a 1024-slot cache: T=128 at write offsets 0 (the
    # 128-token prompt) and 896 (old-cache tiles too), T=512 at 0 (the
    # 512-token prompt)
    T = PROMPT_LEN
    kl, vl = rnd(1, S, Hkv, D), rnd(1, S, Hkv, D)
    blocks = {t: (rnd(1, t, H, D), rnd(1, t, Hkv, D), rnd(1, t, Hkv, D)) for t in (T, 512)}
    for Tp, n in ((T, 0), (T, S - T), (512, 0)):
        qp, kcp, vcp = blocks[Tp]
        seq = torch.tensor([n], dtype=torch.int32, device=dev)
        out = flash_prefill_kernel(qp, kl, vl, kcp, vcp, seq, scale)
        ref = flash_prefill_attention_plain(qp, kl, vl, kcp, vcp, seq, scale)
        qs = qp.transpose(1, 2)
        kfull = torch.cat([kl[:, :n], kcp], 1).transpose(1, 2).contiguous()
        vfull = torch.cat([vl[:, :n], vcp], 1).transpose(1, 2).contiguous()
        allowed = (torch.arange(n + Tp, device=dev)[None, :]
                   <= (n + torch.arange(Tp, device=dev))[:, None])
        lib = sdpa(qs, kfull, vfull, attn_mask=allowed, scale=scale, enable_gqa=True)
        torch.cuda.synchronize()
        log(f"[library] prefill T={Tp} n={n} sdpa vs plain: max rel err "
            f"{rel_err(lib.transpose(1, 2), ref):.3e}")
        no_sync(lambda: flash_prefill_kernel(qp, kl, vl, kcp, vcp, seq, scale))
        log(f"[sync] K5 at T={Tp} seq_len={n} ran with host syncs raising")
        log_device_and_host(f"prefill T={Tp} seq_len={n}", [
            ("K5", lambda: flash_prefill_kernel(qp, kl, vl, kcp, vcp, seq, scale)),
            ("sdpa", lambda: sdpa(qs, kfull, vfull, attn_mask=allowed, scale=scale,
                                  enable_gqa=True))])
        keys = sum(n + t + 1 for t in range(Tp))
        record(f"flash_prefill T={Tp} H={H} Hkv={Hkv} D={D} S={S} seq_len={n}",
               "llamacog_tpu_torch/csrc/flash_prefill.cu",
               "llamacog_tpu/ops/pallas/flash_prefill.py:129", [out], [ref], TOL_ATTN,
               time_ms(lambda: flash_prefill_kernel(qp, kl, vl, kcp, vcp, seq, scale)),
               time_ms(lambda: flash_prefill_attention_plain(qp, kl, vl, kcp, vcp, seq,
                                                             scale), iters=5),
               2 * (qp.numel() + 2 * n * Hkv * D + kcp.numel() + vcp.numel() + Tp * H * D),
               4 * H * keys * D,
               time_ms(lambda: sdpa(qs, kfull, vfull, attn_mask=allowed, scale=scale,
                                    enable_gqa=True)))
    # K5 on a one-row view of a 4-row cache (row 2 of layer 1: what a row
    # prefill reads, Engine.prefill(row=)), T=128 at offsets 0 and 896: the
    # tiles, by the view's strides, no copy
    kl4, vl4 = rnd(2, SERVING_SLOTS, S, Hkv, D), rnd(2, SERVING_SLOTS, S, Hkv, D)
    krow, vrow = kl4[1, 2:3], vl4[1, 2:3]
    qr, kcr, vcr = blocks[T]
    check(krow.data_ptr() == kl4[1, 2].data_ptr(), "K5 row view: not a view of the cache")
    for n in (0, S - T):
        seq = torch.tensor([n], dtype=torch.int32, device=dev)
        args = (qr, krow, vrow, kcr, vcr, seq, scale)
        before = dict(build.LAUNCHES)
        out = flash_prefill_kernel(*args)
        took = {k: c - before[k] for k, c in build.LAUNCHES.items() if c != before[k]}
        check(took == {"flash_prefill": 1}, f"K5 row view n={n}: launched {took}, not the tiles")
        ref = flash_prefill_attention_plain(*args)
        qs = qr.transpose(1, 2)
        kfull = torch.cat([krow[:, :n], kcr], 1).transpose(1, 2).contiguous()
        vfull = torch.cat([vrow[:, :n], vcr], 1).transpose(1, 2).contiguous()
        allowed = (torch.arange(n + T, device=dev)[None, :]
                   <= (n + torch.arange(T, device=dev))[:, None])
        torch.cuda.synchronize()
        keys = sum(n + t + 1 for t in range(T))
        record(f"flash_prefill row view (row 2 of 4) T={T} H={H} Hkv={Hkv} D={D} S={S} "
               f"seq_len={n}", "llamacog_tpu_torch/csrc/flash_prefill.cu",
               "llamacog_tpu/ops/pallas/flash_prefill.py:129", [out], [ref], TOL_ATTN,
               time_ms(lambda: flash_prefill_kernel(*args)),
               time_ms(lambda: flash_prefill_attention_plain(*args), iters=5),
               2 * (qr.numel() + 2 * n * Hkv * D + kcr.numel() + vcr.numel() + T * H * D),
               4 * H * keys * D,
               time_ms(lambda: sdpa(qs, kfull, vfull, attn_mask=allowed, scale=scale,
                                    enable_gqa=True)), run="serving")
    del kl4, vl4, krow, vrow, kfull, vfull, allowed, args, qr, kcr, vcr
    # K5's bf16 SIMT body, which the C entry picks for what the tiles do not
    # take: a head dim outside the tiles (72) and a cache view one element
    # off 16 bytes (8B heads), T=128 over write offset 896. No phase-5 run
    # launches it: there the count flash_prefill_simt is a stray
    n = S - T
    seq = torch.tensor([n], dtype=torch.int32, device=dev)
    for label, Dh, shift in (("D=72", 72, 0), (f"D={D} cache view off 16 bytes", D, 1)):
        kv_flat = [rnd(S * Hkv * Dh + shift) for _ in "kv"]
        ks1, vs1 = (f[shift:].view(1, S, Hkv, Dh) for f in kv_flat)
        qs1, kcs1, vcs1 = rnd(1, T, H, Dh), rnd(1, T, Hkv, Dh), rnd(1, T, Hkv, Dh)
        args = (qs1, ks1, vs1, kcs1, vcs1, seq, Dh ** -0.5)
        before = dict(build.LAUNCHES)
        out = flash_prefill_kernel(*args)
        took = {k: c - before[k] for k, c in build.LAUNCHES.items() if c != before[k]}
        check(took == {"flash_prefill_simt": 1},
              f"K5 bf16 {label}: launched {took}, not the SIMT body once")
        ref = flash_prefill_attention_plain(*args)
        torch.cuda.synchronize()
        keys = sum(n + t + 1 for t in range(T))
        record(f"flash_prefill bf16 SIMT body T={T} H={H} Hkv={Hkv} {label} S={S} seq_len={n}",
               "llamacog_tpu_torch/csrc/flash_prefill.cu",
               "llamacog_tpu/ops/pallas/flash_prefill.py:129", [out], [ref], TOL_ATTN,
               time_ms(lambda: flash_prefill_kernel(*args)),
               time_ms(lambda: flash_prefill_attention_plain(*args), iters=5),
               2 * (qs1.numel() + 2 * n * Hkv * Dh + kcs1.numel() + vcs1.numel() + T * H * Dh),
               4 * H * keys * Dh, counter="flash_prefill_simt", listed=False)
        del kv_flat, ks1, vs1, qs1, kcs1, vcs1, args
    # K4 and K5 at Llama-3-70B's heads (64 query heads over 8 kv heads: 8 a
    # kv head, where the 8B has 4), read in the 70B run of phase 5: decode at
    # depth 1000, the 128-token prompt's prefill at offset 0
    H70 = llama3_70b_config().n_head
    q70, kc70, vc70 = rnd(1, H70, D), rnd(1, Hkv, D), rnd(1, Hkv, D)
    ks70, vs70 = rnd(2, 1, S, Hkv, D), rnd(2, 1, S, Hkv, D)
    n = 1000
    seq = torch.tensor([n], dtype=torch.int32, device=dev)
    args = (q70, ks70, vs70, 1, kc70, vc70, seq, scale)
    out = flash_decode_stacked_dense(*args)
    ref = flash_decode_stacked_dense_plain(*args)
    qf70 = q70[:, :, None]
    kf = torch.cat([ks70[1, :, :n], kc70[:, None]], 1).transpose(1, 2).contiguous()
    vf = torch.cat([vs70[1, :, :n], vc70[:, None]], 1).transpose(1, 2).contiguous()
    torch.cuda.synchronize()
    record(f"flash_decode_dense H={H70} Hkv={Hkv} D={D} S={S} seq_len={n}",
           "llamacog_tpu_torch/csrc/flash_decode_dense.cu",
           "llamacog_tpu/ops/pallas/flash_q8.py:968", [out], [ref], TOL_ATTN,
           time_ms(lambda: flash_decode_stacked_dense(*args)),
           time_ms(lambda: flash_decode_stacked_dense_plain(*args), iters=5),
           2 * (q70.numel() + 2 * n * Hkv * D + kc70.numel() + vc70.numel() + H70 * D),
           4 * H70 * (n + 1) * D,
           time_ms(lambda: sdpa(qf70, kf, vf, scale=scale, enable_gqa=True)), run="70b IQ2_XXS")
    qp70, kcp70, vcp70 = rnd(1, T, H70, D), rnd(1, T, Hkv, D), rnd(1, T, Hkv, D)
    seq = torch.tensor([0], dtype=torch.int32, device=dev)
    args = (qp70, kl, vl, kcp70, vcp70, seq, scale)
    out = flash_prefill_kernel(*args)
    ref = flash_prefill_attention_plain(*args)
    allowed = torch.arange(T, device=dev)[None, :] <= torch.arange(T, device=dev)[:, None]
    qs70, kf, vf = (t.transpose(1, 2) for t in (qp70, kcp70, vcp70))
    torch.cuda.synchronize()
    record(f"flash_prefill T={T} H={H70} Hkv={Hkv} D={D} S={S} seq_len=0",
           "llamacog_tpu_torch/csrc/flash_prefill.cu",
           "llamacog_tpu/ops/pallas/flash_prefill.py:129", [out], [ref], TOL_ATTN,
           time_ms(lambda: flash_prefill_kernel(*args)),
           time_ms(lambda: flash_prefill_attention_plain(*args), iters=5),
           2 * (qp70.numel() + kcp70.numel() + vcp70.numel() + T * H70 * D),
           4 * H70 * (T * (T + 1) // 2) * D,
           time_ms(lambda: sdpa(qs70, kf, vf, attn_mask=allowed, scale=scale, enable_gqa=True)),
           run="70b IQ2_XXS")
    del q70, kc70, vc70, ks70, vs70, qf70, kf, vf, qp70, kcp70, vcp70, qs70, args
    qp, kcp, vcp = blocks[T]
    del kl, vl, blocks, shapes, ws, x, xq, xs, i8_shapes, w, w_qk, w_v, w_o, w_gu, w_d4, w_d6, \
        w_head, w_q4, w_k8, w_v8, w_o5
    torch.cuda.empty_cache()

    # quantized-cache attention: layer 1 of a 2-layer stacked plane cache
    # filled with quantized random K/V at every slot
    log("[parity] flash_decode_quant/flash_prefill_quant: no single PyTorch call attends "
        "over quantized KV planes, so they have no library time (library_ms null)")
    fq8 = "llamacog_tpu/ops/pallas/flash_q8.py:{}"

    def quant_cache(kinds, s_len, batch=1):
        c = QuantKVCache.create(2, batch, s_len, Hkv, D, D, kinds=kinds, device=dev)
        for il in range(2):  # one layer at a time keeps the f32 staging small
            kv = [torch.randn(1, batch, s_len, Hkv, D, generator=g, device=dev) for _ in "kv"]
            part = QuantKVCache([p[il:il + 1] for p in c.k_planes],
                                [p[il:il + 1] for p in c.v_planes], kinds, Hkv)
            part.write_all(*kv, torch.zeros(batch, dtype=torch.int32, device=dev))
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
    # K6 over q8_0 planes at a serving step: B = 4 rows at SERVING_DEPTHS of
    # a 2048-slot cache (its launches: phase 4's 8B 4-row q8_0 engine)
    qc4 = quant_cache(("q8_0", "q8_0"), 2048, batch=SERVING_SLOTS)
    qb, kcb, vcb = rnd(SERVING_SLOTS, H, D), rnd(SERVING_SLOTS, Hkv, D), rnd(SERVING_SLOTS, Hkv, D)
    depths = torch.tensor(SERVING_DEPTHS, dtype=torch.int32, device=dev)
    args = (qb, qc4.k_planes, qc4.v_planes, 1, kcb, vcb, depths, scale)
    out = flash_decode_stacked(*args, kinds=qc4.kinds)
    ref = flash_decode_stacked_plain(*args, kinds=qc4.kinds)
    torch.cuda.synchronize()
    record(f"flash_decode_stacked q8_0:q8_0 B={SERVING_SLOTS} H={H} Hkv={Hkv} D={D} S=2048 "
           "seq_len=" + "/".join(map(str, SERVING_DEPTHS)),
           "llamacog_tpu_torch/csrc/flash_decode_quant.cu", fq8.format(828), [out], [ref],
           TOL_ATTN, time_ms(lambda: flash_decode_stacked(*args, kinds=qc4.kinds)),
           time_ms(lambda: flash_decode_stacked_plain(*args, kinds=qc4.kinds), iters=5),
           sum(SERVING_DEPTHS) * Hkv * 2 * row_bytes("q8_0")
           + 2 * (qb.numel() + kcb.numel() + vcb.numel() + SERVING_SLOTS * H * D),
           4 * H * sum(n + 1 for n in SERVING_DEPTHS) * D, run=f"8b {SERVING_SLOTS} rows q8_0")
    del qc4, args, out, ref

    def prefill_row(label, cache, kinds, qp, kcp, vcp, n, run=None, dense_run=None):
        """K7 on layer 1 of `cache` at write offset n: its tensor-core tiles
        (one launch, checked), against its plain version, its launches read
        from the phase-5 run `run`; with dense_run, K5 on the same shape
        over a dense bf16 cache of the same values (the planes dequantized
        and rounded to bf16: what K7's tiles multiply) in its own row, with
        SDPA as its library call and its launches from `dense_run`."""
        Tq, S_c = qp.shape[1], cache.max_seq
        kp, vp = [p[1] for p in cache.k_planes], [p[1] for p in cache.v_planes]
        seq = torch.tensor([n], dtype=torch.int32, device=dev)
        args = (qp, kp, vp, kcp, vcp, seq, scale)
        before = dict(build.LAUNCHES)
        out = flash_prefill_q8(*args, kinds=kinds)
        took = {k: c - before[k] for k, c in build.LAUNCHES.items() if c != before[k]}
        check(took == {"flash_prefill_quant": 1}, f"K7 {label}: launched {took}, not the tiles")
        ref = flash_prefill_q8_plain(*args, kinds=kinds)
        torch.cuda.synchronize()
        keys = sum(n + t + 1 for t in range(Tq))
        io_bytes = 2 * (qp.numel() + kcp.numel() + vcp.numel() + Tq * H * D)
        shape = f"T={Tq} H={H} Hkv={Hkv} D={D} S={S_c} seq_len={n}"
        record(f"flash_prefill_q8 {kinds[0]}:{kinds[1]} {shape}",
               "llamacog_tpu_torch/csrc/flash_prefill_quant.cu", fq8.format(331), [out], [ref],
               TOL_ATTN, time_ms(lambda: flash_prefill_q8(*args, kinds=kinds)),
               time_ms(lambda: flash_prefill_q8_plain(*args, kinds=kinds), iters=5),
               n * Hkv * (row_bytes(kinds[0]) + row_bytes(kinds[1])) + io_bytes,
               4 * H * keys * D, run=run)
        if dense_run is None:
            return
        kd, vd = (kv_dequant_planes(kind, tuple(p.reshape(1, S_c, Hkv, -1) for p in planes),
                                    torch.float32).to(torch.bfloat16)
                  for kind, planes in zip(kinds, (kp, vp)))
        dargs = (qp, kd, vd, kcp, vcp, seq, scale)
        out = flash_prefill_kernel(*dargs)
        ref = flash_prefill_attention_plain(*dargs)
        qs = qp.transpose(1, 2)
        kfull = torch.cat([kd[:, :n], kcp], 1).transpose(1, 2).contiguous()
        vfull = torch.cat([vd[:, :n], vcp], 1).transpose(1, 2).contiguous()
        allowed = (torch.arange(n + Tq, device=dev)[None, :]
                   <= (n + torch.arange(Tq, device=dev))[:, None])
        torch.cuda.synchronize()
        log_device_and_host(f"prefill {kinds[0]}:{kinds[1]} {shape}", [
            ("K7", lambda: flash_prefill_q8(*args, kinds=kinds)),
            ("K5 dense", lambda: flash_prefill_kernel(*dargs))])
        record(f"flash_prefill {shape} (dense bf16 of the {kinds[0]}:{kinds[1]} values, "
               f"beside K7)", "llamacog_tpu_torch/csrc/flash_prefill.cu",
               "llamacog_tpu/ops/pallas/flash_prefill.py:129", [out], [ref], TOL_ATTN,
               time_ms(lambda: flash_prefill_kernel(*dargs)),
               time_ms(lambda: flash_prefill_attention_plain(*dargs), iters=5),
               2 * 2 * n * Hkv * D + io_bytes, 4 * H * keys * D,
               time_ms(lambda: sdpa(qs, kfull, vfull, attn_mask=allowed, scale=scale,
                                    enable_gqa=True)), run=dense_run)
        del kd, vd, kfull, vfull, allowed, dargs

    # K7 over every kind pair of the decode rows at T=128 from write offset
    # 896 (old-cache tiles), three of them also from 0 (the current block
    # alone); then the 2048-token chunks of the deep runs of phase 5 (q8_0
    # and q4_0, from offsets 0 and 2048 of a 4096-slot layer), each with K5
    # beside it
    for kinds in pairs:
        cache = quant_cache(kinds, S)
        for n in ((0, S - T) if kinds in (("q8_0", "q8_0"), ("q4_0", "q4_0"), ("q8_0", "q5_1"))
                  else (S - T,)):
            prefill_row("T=128", cache, kinds, qp, kcp, vcp, n)
        del cache
    # K7 on a one-row view of a 4-row q8_0 cache (row 2 of layer 1: a row
    # prefill over quantized planes), T=128 at offsets 0 and 896: the tiles,
    # on the view's planes in place (a layer of one row is contiguous); its
    # launches: phase 4's 8B 4-row q8_0 engine
    qc4 = quant_cache(("q8_0", "q8_0"), S, batch=SERVING_SLOTS)
    kp, vp = [p[1, 2:3] for p in qc4.k_planes], [p[1, 2:3] for p in qc4.v_planes]
    check(all(p.is_contiguous() for p in kp + vp), "K7 row view: planes not contiguous")
    for n in (0, S - T):
        seq = torch.tensor([n], dtype=torch.int32, device=dev)
        args = (qp, kp, vp, kcp, vcp, seq, scale)
        before = dict(build.LAUNCHES)
        out = flash_prefill_q8(*args, kinds=qc4.kinds)
        took = {k: c - before[k] for k, c in build.LAUNCHES.items() if c != before[k]}
        check(took == {"flash_prefill_quant": 1},
              f"K7 row view n={n}: launched {took}, not the tiles")
        ref = flash_prefill_q8_plain(*args, kinds=qc4.kinds)
        torch.cuda.synchronize()
        keys = sum(n + t + 1 for t in range(T))
        record(f"flash_prefill_q8 row view (row 2 of 4) q8_0:q8_0 T={T} H={H} Hkv={Hkv} D={D} "
               f"S={S} seq_len={n}", "llamacog_tpu_torch/csrc/flash_prefill_quant.cu",
               fq8.format(331), [out], [ref], TOL_ATTN,
               time_ms(lambda: flash_prefill_q8(*args, kinds=qc4.kinds)),
               time_ms(lambda: flash_prefill_q8_plain(*args, kinds=qc4.kinds), iters=5),
               n * Hkv * 2 * row_bytes("q8_0")
               + 2 * (qp.numel() + kcp.numel() + vcp.numel() + T * H * D),
               4 * H * keys * D, run=f"8b {SERVING_SLOTS} rows q8_0")
    del qc4, kp, vp, args
    Tl = 2048
    ql, kcl, vcl = rnd(1, Tl, H, D), rnd(1, Tl, Hkv, D), rnd(1, Tl, Hkv, D)
    for kind in ("q8_0", "q4_0"):
        cache = quant_cache((kind, kind), 2 * Tl)
        for n, run in ((0, "q8_0 2048"), (Tl, "q8_0 4096")):
            prefill_row(f"T={Tl}", cache, (kind, kind), ql, kcl, vcl, n,
                        run=run if kind == "q8_0" else None, dense_run="long 4096")
        del cache
        torch.cuda.empty_cache()
    # K7's SIMT body, which the C entry picks for f32 and for the bf16 calls
    # the tiles do not take (here a q one element off 16 bytes), T=128 over
    # write offset 896. No phase-5 run launches it: there the count
    # flash_prefill_quant_simt is a stray
    cache = quant_cache(("q8_0", "q8_0"), S)
    kp, vp = [p[1] for p in cache.k_planes], [p[1] for p in cache.v_planes]
    n = S - T
    seq = torch.tensor([n], dtype=torch.int32, device=dev)
    q_off = rnd(T * H * D + 1)[1:].view(1, T, H, D)
    for label, q_s, kc_s, vc_s in (("f32", qp.float(), kcp.float(), vcp.float()),
                                   ("bf16 q off 16 bytes", q_off, kcp, vcp)):
        args = (q_s, kp, vp, kc_s, vc_s, seq, scale)
        before = dict(build.LAUNCHES)
        out = flash_prefill_q8(*args)
        took = {k: c - before[k] for k, c in build.LAUNCHES.items() if c != before[k]}
        check(took == {"flash_prefill_quant_simt": 1},
              f"K7 {label}: launched {took}, not the SIMT body once")
        ref = flash_prefill_q8_plain(*args)
        torch.cuda.synchronize()
        keys = sum(n + t + 1 for t in range(T))
        elt = q_s.element_size()
        record(f"flash_prefill_q8 SIMT body {label} q8_0:q8_0 T={T} H={H} Hkv={Hkv} D={D} "
               f"S={S} seq_len={n}", "llamacog_tpu_torch/csrc/flash_prefill_quant.cu",
               fq8.format(331), [out], [ref], 1e-5 if elt == 4 else TOL_ATTN,
               time_ms(lambda: flash_prefill_q8(*args)),
               time_ms(lambda: flash_prefill_q8_plain(*args), iters=5),
               n * Hkv * 2 * row_bytes("q8_0")
               + elt * (q_s.numel() + kc_s.numel() + vc_s.numel() + T * H * D),
               4 * H * keys * D, peak=BF16_FLOPS if elt == 2 else F32_FLOPS,
               counter="flash_prefill_quant_simt", listed=False)
    del cache, kp, vp, q_off, ql, kcl, vcl, args, out, ref
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
    # the grouped GEMM of a 128-token prefill (256 rows sorted by expert,
    # each expert's padded to the model's token tile) and of a 512-token one
    # (1024 rows: several tiles an expert)
    for tokens in (PROMPT_LEN, 512):
        ids = route(tokens)
        dest, tile_expert, s_pad = moe_sort(ids, n_exp, RAGGED_TILE)
        counts = torch.bincount(ids.long(), minlength=n_exp).tolist()
        log(f"[parity] qgemm_id {tokens} tokens: rows per expert {counts}, s_pad {s_pad}")
        for label, w in (("ffn_gate_up_exps Q4_K 8x28672x4096", moe_gu),
                         ("ffn_down_exps Q6_K 8x4096x14336", moe_d6)):
            _, Nw, Kw = w.shape
            rows = torch.randn(ids.shape[0], Kw, generator=g, device=dev).to(torch.bfloat16)
            xs = torch.zeros(s_pad, Kw, dtype=torch.bfloat16, device=dev).index_copy_(
                0, dest, rows)
            out = qmm_ragged(xs, tile_expert, w, RAGGED_TILE)
            ref = qmm_ragged_plain(xs, tile_expert, w, RAGGED_TILE)
            torch.cuda.synchronize()
            record(f"qgemm_id ragged {label} tokens={tokens} rows={ids.shape[0]} "
                   f"s_pad={s_pad}", qmm_src.format("qgemm_id"), qid_rep.format(188), [out],
                   [ref], TOL_QMM, time_ms(lambda: qmm_ragged(xs, tile_expert, w, RAGGED_TILE)),
                   time_ms(lambda: qmm_ragged_plain(xs, tile_expert, w, RAGGED_TILE), iters=5),
                   expert_bytes(w, ids) + ids.shape[0] * (Kw * 2 + Nw * 4),
                   2 * ids.shape[0] * Nw * Kw, run="mixtral" if tokens == PROMPT_LEN
                   else "mixtral 512")
            del out, ref, xs, rows
    # every other expert kind (Q5_K and Q8_0 among them) at both expert
    # shapes, gate_up (K 4096) and down (K 14336: 56 superblocks a row, the
    # raw ring's row layout and chunking at the other width): the gather at
    # 2 and 32 rows, the grouped GEMM of a 128- and a 512-token prefill,
    # each read in the Mixtral run of a preset that holds the kind
    # (EXPERT_PRESET)
    for kind, preset in EXPERT_PRESET.items():
        run = f"mixtral {preset}"
        for stem, Nw, Kw in (("ffn_gate_up_exps", 2 * Fm, E), ("ffn_down_exps", E, Fm)):
            w = random_experts(kind, n_exp, Nw, Kw, g, dev)
            label = f"{stem} {kind} {n_exp}x{Nw}x{Kw}"
            # the gather at 2 and 32 rows; the 1-2 bit and ternary kinds also
            # through the offset entry (K12) at 2
            for tokens, fn, entry, line in (
                    (1, qmm_gather, "gather", 115), (16, qmm_gather, "gather", 115),
                    *([(1, qmm_gather_offset, "offset", 267)] if kind in LOW_BIT_KINDS else [])):
                ids = route(tokens)
                x = torch.randn(ids.shape[0], Kw, generator=g, device=dev).to(torch.bfloat16)
                out, ref = fn(x, ids, w), qmm_gather_plain(x, ids, w)
                torch.cuda.synchronize()
                record(f"qmv_id {entry} {label} S={ids.shape[0]}", qmm_src.format("qmv_id"),
                       qid_rep.format(line), [out], [ref], TOL_QMM,
                       time_ms(lambda: fn(x, ids, w)),
                       time_ms(lambda: qmm_gather_plain(x, ids, w), iters=5),
                       expert_bytes(w, ids) + x.numel() * 2 + out.numel() * 4,
                       2 * ids.shape[0] * Nw * Kw, run=run)
            for tokens in (PROMPT_LEN, 512):
                ids = route(tokens)
                dest, tile_expert, s_pad = moe_sort(ids, n_exp, RAGGED_TILE)
                rows = torch.randn(ids.shape[0], Kw, generator=g, device=dev).to(torch.bfloat16)
                xs = torch.zeros(s_pad, Kw, dtype=torch.bfloat16, device=dev).index_copy_(
                    0, dest, rows)
                out = qmm_ragged(xs, tile_expert, w, RAGGED_TILE)
                ref = qmm_ragged_plain(xs, tile_expert, w, RAGGED_TILE)
                torch.cuda.synchronize()
                record(f"qgemm_id ragged {label} tokens={tokens} rows={ids.shape[0]} "
                       f"s_pad={s_pad}", qmm_src.format("qgemm_id"), qid_rep.format(188), [out],
                       [ref], TOL_QMM, time_ms(lambda: qmm_ragged(xs, tile_expert, w, RAGGED_TILE)),
                       time_ms(lambda: qmm_ragged_plain(xs, tile_expert, w, RAGGED_TILE), iters=5),
                       expert_bytes(w, ids) + ids.shape[0] * (Kw * 2 + Nw * 4),
                       2 * ids.shape[0] * Nw * Kw, run=run)
                del xs, rows
            del w, out, ref
            torch.cuda.empty_cache()

    # the MoE FFN keeps routing on the device: a decode step (2 rows, the
    # gather) and 128- and 512-token prefills (the grouped GEMM) run with any
    # synchronizing call raising
    moe_layer = {"ffn_gate_inp": torch.randn(n_exp, E, generator=g, device=dev) * 0.02,
                 "ffn_gate_up_exps": moe_gu, "ffn_down_exps": moe_d6}

    for T_moe in (1, PROMPT_LEN, 512):
        h_moe = torch.randn(1, T_moe, E, generator=g, device=dev).to(torch.bfloat16)
        out = no_sync(lambda: _ffn_moe(moe_layer, h_moe, mcfg))
        check(out.shape == h_moe.shape and bool(torch.isfinite(out).all()),
              f"MoE FFN at T={T_moe}: output not finite of shape {tuple(h_moe.shape)}")
        log(f"[moe] _ffn_moe T={T_moe} ({T_moe * k_used} rows) ran with no host sync")
    del moe_gu, moe_d6, moe_layer, x, out
    torch.cuda.empty_cache()

    phase_s["phase 3"] = time.perf_counter() - t3
    log(f"[parity] done in {phase_s['phase 3']:.1f}s")

    # 4. full-width kernel path vs the plain path (same params on the CPU)
    t0 = time.perf_counter()
    dense_attn = ("flash_decode_dense", "flash_prefill")
    quant_attn = ("flash_decode_quant", "flash_prefill_quant")
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

    def two_copies(cfgp, ftype=DEFAULT_LAYOUT):
        """The synthetic params on the card, and a copy on the CPU for the
        plain path whose wire weights keep their plain dequant
        (wire.keep_decoded): the plain path's products read the same f32
        weights each step instead of decoding them again, most of its time
        otherwise (4 bytes a weight: a 2-layer Mixtral-wide copy holds its
        expert stacks in ~11 GB of host memory). The dequant runs on the
        card, the same torch ops as on the CPU, and is copied over (decoding
        the copies on the host took ~45% of phase 4); a sample of each
        weight's rows (every expert's first and last, and 32 drawn from the
        whole weight) is decoded on the CPU too and must be bit-equal."""
        p_gpu = make_synthetic_params(cfgp, seed=7, ftype=ftype,
                                      imatrix=ftype in CODEBOOK_PRESETS)
        draw = torch.Generator().manual_seed(7)

        def on_cpu(v):
            if not isinstance(v, WireTensor):
                return v.to("cpu")
            w, decoded = v.to("cpu"), dequantize(v).cpu()
            n_rows, n, k = w.blocks.shape[0], w.shape[-2], w.shape[-1]
            firsts = torch.arange(0, n_rows, n)  # one a stack's expert
            idx = torch.cat([firsts, firsts + n - 1,
                             torch.randint(n_rows, (32,), generator=draw)]).unique()
            rows = dequantize(WireTensor(w.kind, (len(idx), k), w.blocks.index_select(0, idx)))
            check(torch.equal(rows, decoded.reshape(-1, k).index_select(0, idx)),
                  f"{w.kind} {tuple(w.shape)}: the plain dequant on the card is not the CPU's")
            return WireTensor(w.kind, w.shape, w.blocks, w.qi8, w.ws8T, decoded)
        p_cpu = {k: (v if k == "layers" else on_cpu(v)) for k, v in p_gpu.items()}
        p_cpu["layers"] = [{k: on_cpu(v) for k, v in layer.items()} for layer in p_gpu["layers"]]
        return p_gpu, p_cpu

    @contextlib.contextmanager
    def routing_record(cfgp, rows, seen):
        """The kernel path's routing on a MoE model: each call of the
        forward's router (one a layer) also writes its layer's top-k expert
        ids [rows <= `rows`, k] into buffers on the card (the copies recorded
        into a captured decode graph refill them at every replay). Yields a
        function, called after each step, that appends the step's (ids
        [n_layer, rows, k], rows a layer) to `seen`."""
        if not cfgp.n_expert:
            yield lambda: None
            return
        k, n_l = cfgp.n_expert_used, cfgp.n_layer
        ids = torch.zeros((n_l, rows, k), dtype=torch.long, device=dev)
        used = torch.zeros(n_l, dtype=torch.long, device=dev)
        orig, calls = llama_mod._moe_router, [0]

        def recorded(layer, x, cfg):
            top_i, gate_w = orig(layer, x, cfg)
            flat = top_i.reshape(-1, k)
            il = calls[0] % n_l
            calls[0] += 1
            ids[il, : flat.shape[0]].copy_(flat)
            used[il].fill_(flat.shape[0])
            return top_i, gate_w

        llama_mod._moe_router = recorded
        try:
            yield lambda: seen.append((ids.cpu().clone(), used.cpu().clone()))
        finally:
            llama_mod._moe_router = orig

    @contextlib.contextmanager
    def routing_forced(cfgp, seen, real_rows, diffs):
        """The plain path of a MoE model routed as the kernel path was: each
        router call takes the experts that routing_record saw the kernel
        path choose in the same step and layer (`seen`), weighted by the
        plain path's own gate probabilities. Every real row (the first
        real_rows[step] rows; the rest are the prompt bucket's padding)
        whose experts differ from the plain path's own top-k is appended to
        `diffs` with whether it is a tie swap: the kernel path took the
        plain path's (k+1)-th expert for its k-th, and the two logits lie
        within TIE_ULPS bf16 ulps. Yields the function that ends a step."""
        if not cfgp.n_expert:
            yield lambda: None
            return
        k, n_l, step, calls = cfgp.n_expert_used, cfgp.n_layer, [0], [0]
        orig = llama_mod._moe_router

        def route_as_kernel(layer, x, cfg):
            check(cfg.expert_gating_func != "sigmoid" and "exp_probs_b" not in layer,
                  "the forced router repeats softmax gating without a selection bias only")
            logits = qmatmul(x, layer["ffn_gate_inp"]).float()
            il = calls[0] % n_l
            calls[0] += 1
            ids, used = seen[step[0]]
            n_rows = logits.reshape(-1, logits.shape[-1]).shape[0]
            check(int(used[il]) == n_rows, f"layer {il} step {step[0]}: the plain path routes "
                  f"{n_rows} rows, the kernel path routed {int(used[il])}")
            top_i = ids[il, :n_rows].reshape(*logits.shape[:-1], k)
            gate_w = torch.gather(torch.softmax(logits, dim=-1), -1, top_i)
            if cfg.expert_weights_norm:
                gate_w = gate_w / (gate_w.sum(dim=-1, keepdim=True) + 1e-20)
            real = real_rows[step[0]]
            own_l, own_i = torch.topk(logits.reshape(-1, logits.shape[-1])[:real], k + 1, dim=-1)
            got = top_i.reshape(-1, k)[:real].sort(dim=1).values
            for r in torch.nonzero((own_i[:, :k].sort(dim=1).values != got).any(dim=1)).flatten():
                r = int(r)
                swap = torch.cat([own_i[r, : k - 1], own_i[r, k:]]).sort().values
                hi, lo = float(own_l[r, k - 1]), float(own_l[r, k])
                ulp = 2.0 ** (torch.frexp(own_l[r, k - 1]).exponent.item() - 8)
                diffs.append({"step": step[0], "layer": il, "row": r, "kernel": got[r].tolist(),
                              "plain top-k+1": own_i[r].tolist(), "gap_ulps": (hi - lo) / ulp,
                              "tie": torch.equal(swap, got[r]) and hi - lo <= TIE_ULPS * ulp})
            return top_i, gate_w * cfg.expert_weights_scale

        def end_step():
            step[0] += 1

        llama_mod._moe_router = route_as_kernel
        try:
            yield end_step
        finally:
            llama_mod._moe_router = orig

    def path_check(model, cfgp, p_gpu, p_cpu, cases, forced, max_seq):
        """For each case (label, kv type, environment, prompt, kernels that
        must launch, the T=1 attention route that must run, and optionally
        the model's dtype, bf16 by default), under the case's environment: prefill, teacher-forced decode steps and a
        9-token second chunk (which attends the cache of the first) through
        Engine on the card and on the CPU, the same params; logits held
        within TOL_PATH at every step. On a MoE model the router's bf16
        logits can tie, and a tie broken the other way runs other experts:
        the plain path therefore routes as the kernel path did
        (routing_forced), and every real row where that differs from its
        own top-k must be a tie swap. Returns the card's first prefill
        logits per case."""
        Vp = cfgp.n_vocab
        firsts = {}
        for label, kv_type, env, prompt, must, route, *dtype in cases:
            dtype = dtype[0] if dtype else torch.bfloat16
            t_case = time.perf_counter()
            runs, seen, diffs = {}, [], []
            real_rows = [len(prompt)] + [1] * len(forced) + [9]
            with env_vars(env):
                for name, params, device in (("kernel", p_gpu, "cuda"), ("plain", p_cpu, "cpu")):
                    eng = Engine(params, cfgp, batch_size=1, max_seq=max_seq, kv_type=kv_type,
                                 dtype=dtype, device=device)
                    build.reset_launches()
                    routing = (routing_record(cfgp, max_seq, seen) if name == "kernel"
                               else routing_forced(cfgp, seen, real_rows, diffs))
                    with route_calls() as calls, routing as end_step:
                        steps = [eng.prefill(prompt)]
                        end_step()
                        for tok in forced:
                            steps.append(eng.decode_one([tok])[0])
                            end_step()
                        steps.append(eng.prefill(prompt[:9]))
                        end_step()
                    runs[name] = steps
                    graphs = {cap: n for cap, (_, n) in eng.decoder.graphs.items()}
                    del eng
                    if name == "kernel":
                        log(f"[path] {model}, {label}: kernel launches "
                            f"{json.dumps({k: v for k, v in build.LAUNCHES.items() if v})}, "
                            f"T=1 attention calls {json.dumps(calls)}, decode graphs "
                            f"(kv_cap: captured launches) {graphs}")
                        missing = [k for k in must if build.LAUNCHES[k] == 0]
                        check(not missing, f"{model} {label}: kernels never launched: {missing}")
                        # the decode steps replay one graph: the forward ran at
                        # T=1 twice, in its eager warm-up step and its capture
                        check(len(graphs) == 1, f"{model} {label}: decode graphs {graphs}")
                        want = {k: 2 * cfgp.n_layer if k == route else 0 for k in calls}
                        check(calls == want, f"{model} {label}: T=1 attention took {calls}, "
                              f"not the {route} route")
            firsts[label] = runs["kernel"][0]
            if cfgp.n_expert:
                log(f"[path] {model}, {label}: the plain path routed as the kernel path; "
                    f"{len(diffs)} real rows differ from its own top-{cfgp.n_expert_used} "
                    f"{json.dumps(diffs)}")
                check(all(d["tie"] for d in diffs),
                      f"{model} {label}: the kernel path routed a row away from the plain "
                      f"path's top-{cfgp.n_expert_used} other than by a tie swap")
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
            log(f"[path] {model}, {label}: {time.perf_counter() - t_case:.1f}s")
        return firsts

    def batched_path_check(model, cfgp, p_gpu, p_cpu, kv_type, must, max_seq, prompts,
                           dtype=torch.bfloat16):
        """A SERVING_SLOTS-row engine on the card, the same params as the
        plain path's: rows 0-2 prefilled one by one with `prompts` (the
        forward at B = 1 over each row's view of the cache), row 3 idle at
        depth 0; four decode_one steps with row 3 inactive and row 1 too in
        the second (teacher-forced tokens); shift_row on row 2; two more
        steps. The bf16 model's run (its launches counted from 0, returned):
        the kernels `must` launched, each step one replay of the one decode
        graph; each row's logits at every step those of a single-stream
        engine on the card fed the row's own calls (within TOL_ROWS: the
        rows do not interact, and the row view, the write mask and the
        shift change nothing; within TOL_PATH on a MoE model, whose f32
        router product goes to cuBLAS, which picks its kernel by the row
        count, so a tie may route otherwise). Then the model in `dtype` on
        the card (the bf16 run itself for bf16) against the same calls on
        the plain path on the CPU, in `dtype`, within TOL_PATH at every
        step, and the rows' lengths equal (where their caches part is
        logged). The 8B runs this comparison as an
        f32 model, as phase 4's Mixtral IQ3_XXS case: in bf16 its own plain
        path moves by up to 1.3 of max |logit| at some states when its
        activations are f32 instead (PERF.md §6, PR 14), so a bf16
        comparison cannot tell a kernel defect from that sensitivity. A MoE
        model's plain path routes as the kernel path did, ties only
        (path_check)."""
        nb = SERVING_SLOTS
        t_case = time.perf_counter()
        idle = np.array([True, True, True, False])
        actives = [idle, np.array([True, False, True, False]), idle, idle, idle, idle]
        tokens = [np.array([(7919 * (i + 3) * (r + 1)) % cfgp.n_vocab for r in range(nb)])
                  for i in range(len(actives))]
        real_rows = [len(p) for p in prompts] + [nb] * len(actives)
        runs, seen, diffs, caches = {}, [], [], {}

        def run(name, params, device, dtype, want_launched):
            eng = Engine(params, cfgp, batch_size=nb, max_seq=max_seq, kv_type=kv_type,
                         device=device, dtype=dtype)
            if device == "cuda":
                seen.clear()
            build.reset_launches()
            routing = (routing_record(cfgp, max_seq, seen) if device == "cuda"
                       else routing_forced(cfgp, seen, real_rows, diffs))
            steps = []
            with route_calls() as calls, routing as end_step:
                for row, prompt in enumerate(prompts):
                    steps.append(("prefill row %d" % row, {row: eng.prefill(prompt, row=row)}))
                    end_step()
                for i, (toks, act) in enumerate(zip(tokens, actives)):
                    if i == 4:
                        eng.shift_row(2, 4, 16)
                    logits = eng.decode_one(toks, active=act)
                    steps.append((f"decode step {i + 1}" + (" after shift_row(2, 4, 16)"
                                                            if i >= 4 else ""),
                                  {r: logits[r] for r in np.nonzero(act)[0].tolist()}))
                    end_step()
            launches = dict(build.LAUNCHES)
            runs[name] = (steps, eng.seq_len.tolist())
            caches[name] = [p.cpu() for p in eng.cache.planes()]
            graphs = {cap: n for cap, (_, n) in eng.decoder.graphs.items()}
            del eng
            if device == "cuda":
                log(f"[path] {model}, {nb} rows, kv {kv_type}, {name}: kernel launches "
                    f"{json.dumps({k: v for k, v in launches.items() if v})}, T=1 "
                    f"attention calls {json.dumps(calls)}, decode graphs {graphs}")
                missing = [k for k in want_launched if launches[k] == 0]
                check(not missing, f"{model} {nb} rows {kv_type} {name}: kernels never "
                      f"launched: {missing}")
                check(len(graphs) == 1 and calls["stacked"] == 2 * cfgp.n_layer,
                      f"{model} {nb} rows {kv_type} {name}: decode graphs {graphs}, T=1 "
                      f"attention calls {calls}: not one graph replayed every step")
            return launches

        launches = run("bf16", p_gpu, "cuda", torch.bfloat16, must)
        # each row alone: a single-stream engine on the card, the row's calls
        single = [dict() for _ in runs["bf16"][0]]
        for row, prompt in enumerate(prompts):
            eng = Engine(p_gpu, cfgp, batch_size=1, max_seq=max_seq, kv_type=kv_type)
            single[row][row] = eng.prefill(prompt)
            for i, (toks, act) in enumerate(zip(tokens, actives)):
                if i == 4 and row == 2:
                    eng.shift_row(0, 4, 16)
                if act[row]:
                    single[len(prompts) + i][row] = eng.decode_one([toks[row]])[0]
            del eng
        worst_rows, tol_rows = 0.0, TOL_PATH if cfgp.n_expert else TOL_ROWS
        for (what, a), alone in zip(runs["bf16"][0], single):
            check(sorted(a) == sorted(alone), f"{model} {nb} rows {what}: rows {sorted(a)} "
                  f"against single-stream rows {sorted(alone)}")
            for r in a:
                err = rel_err(torch.from_numpy(a[r]), torch.from_numpy(alone[r]))
                worst_rows = max(worst_rows, err)
                check(err <= tol_rows, f"{model} {nb} rows {kv_type}: row {r} at {what} "
                      f"differs from its single-stream engine by {err:.3e}")
        log(f"[path] {model}, {nb} rows, kv {kv_type}: the bf16 rows against single-stream "
            f"engines: max rel err {worst_rows:.3e}")
        # the kernel path against the plain path, both in `dtype`
        dname = "bf16" if dtype == torch.bfloat16 else "f32"
        if dname != "bf16":  # f32: qmv for every product, the SIMT prefill bodies
            run(dname, p_gpu, "cuda", dtype,
                ("qmv", *(k for k in must if k.startswith("flash_decode"))))
        run(f"plain {dname}", p_cpu, "cpu", dtype, ())
        if cfgp.n_expert:
            log(f"[path] {model}, {nb} rows: {len(diffs)} real rows routed otherwise than the "
                f"plain path's own top-{cfgp.n_expert_used} {json.dumps(diffs)}")
            check(all(d["tie"] for d in diffs), f"{model} {nb} rows: a row routed away from "
                  "the plain path's top-k other than by a tie swap")
        (k_steps, k_len), (p_steps, p_len) = runs[dname], runs[f"plain {dname}"]
        check(k_len == p_len, f"{model} {nb} rows: lengths {k_len} != {p_len}")
        worst = 0.0
        for (what, a), (_, b) in zip(k_steps, p_steps):
            check(sorted(a) == sorted(b), f"{model} {nb} rows {what}: rows {sorted(a)} "
                  f"against the plain path's {sorted(b)}")
            for r in a:
                ka, pb = torch.from_numpy(a[r]), torch.from_numpy(b[r])
                check(ka.shape == (cfgp.n_vocab,) and bool(torch.isfinite(ka).all()),
                      f"{model} {nb} rows {what} row {r}: logits not finite of shape")
                err = rel_err(ka, pb)
                worst = max(worst, err)
                log(f"[path] {model}, {nb} rows, kv {kv_type}, {dname}, {what}, row {r}: logits "
                    f"max rel err {err:.3e} (tol {TOL_PATH:.0e}), argmax kernel "
                    f"{int(ka.argmax())} plain {int(pb.argmax())}")
                check(err <= TOL_PATH, f"{model} {nb} rows {kv_type} {dname}: kernel path "
                      f"disagrees with the plain path at {what}, row {r}")
        # where the two caches part, over each row's valid slots (a quantized
        # value on either side of a rounding boundary lands one step apart)
        parts = []
        for i, (a, b) in enumerate(zip(caches[dname], caches[f"plain {dname}"])):
            for r, n in enumerate(k_len):
                d = (a[:, r, :n].double() - b[:, r, :n].double()).abs()
                if d.numel() and float(d.max()) > 0:
                    parts.append(f"store {i} ({a.dtype}) row {r}: {int((d > 0).sum())} of "
                                 f"{d.numel()} values differ, by at most {float(d.max()):.3e}")
        log(f"[path] {model}, {nb} rows, kv {kv_type}, {dname} caches, kernel against plain: "
            + ("; ".join(parts) or "equal"))
        log(f"[path] {model}, {nb} rows, kv {kv_type}: lengths {k_len}; {dname} kernel against "
            f"plain max rel err {worst:.3e}; {time.perf_counter() - t_case:.1f}s")
        return launches

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
        (mmq_label, "dense", {"LLAMACOG_MMQ": "1"}, prompt300, ("qmm_i8", "quantize_i8"),
         "stacked"),
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
    # the B-row engine: row prefills of 20, 9 and 33 tokens, decode steps
    # with inactive rows (qmv at 4 rows, K4/K6 over rows at their own depths
    # and one at 0), shift_row; against the plain path as an f32 model. The
    # q8_0 run's launches are those of phase 3's K6 row at 4 rows and K7 row
    # on a one-row view: the serving run of phase 5 has the dense cache
    prompts_b = [prompt20, prompt300[:9], [(i * 7919) % V for i in range(40, 73)]]
    for kv_type, attn in (("dense", dense_attn), ("q8_0", quant_attn)):
        launches = batched_path_check("8B widths", cfg2, p_gpu, p_cpu, kv_type,
                                      ("qmv", "qgemm", *attn), 1024, prompts_b, torch.float32)
        rows_runs[f"8b {SERVING_SLOTS} rows {kv_type}"] = {"total": launches}
    del p_gpu, p_cpu, exact, mm
    torch.cuda.empty_cache()
    # the other presets at 8B widths: legacy Q4_0 (q+k+v and gate+up fused)
    # under int8 prefill (its planes made by the plain dequant; its decode
    # steps take qmv and its 9-token second chunk qgemm, so it also holds
    # what a dense-prefill Q4_0 case held, and the phase keeps its time) and
    # Q5_1; Q3_K_M (layers 0-1: a Q3_K attn_qk + Q5_K attn_v launch, Q5_K
    # ffn_down) and Q2_K (Q4_K attn_v, Q3_K attn_output and ffn_down); IQ4_XS
    # (an IQ4_XS attn_qk + Q5_K attn_v launch) and IQ3_XXS (all three grid
    # kinds: IQ2_S attn_qk + Q4_K attn_v, IQ3_S attn_output and token_embd,
    # IQ3_XXS FFN)
    # IQ1_M: the delta per 8 weights, the scale per 16, the f16 d spread over
    # the scale words (IQ1_M attn_qk + Q4_K attn_v, IQ2_XXS attn_output, Q2_K
    # token_embd, Q5_K output)
    for preset in ("Q4_0", "Q5_1", "Q3_K_M", "Q2_K", "IQ4_XS", "IQ3_XXS", "IQ1_M"):
        p_gpu, p_cpu = two_copies(cfg2, preset)
        if preset == "Q4_0":
            cases = [(f"{preset} {mmq_label}", "dense", {"LLAMACOG_MMQ": "1"}, prompt300,
                      ("qmv", "qgemm", "qmm_i8", "quantize_i8"), "stacked")]
        else:
            cases = [(f"{preset} kv dense", "dense", {}, prompt20, ("qmv", "qgemm"), "stacked")]
        path_check("8B widths", cfg2, p_gpu, p_cpu, cases, [11, 12345, 777, 90000], 1024)
        del p_gpu, p_cpu
        torch.cuda.empty_cache()
    # Mixtral widths: the 20-token prefill (bucket 32: 64 rows) takes the
    # grouped GEMM, each decode step (2 rows) the gather; max_seq 33 makes
    # the second chunk an exact tail fit of 9 tokens (18 rows: the gather)
    mcfg2 = mixtral_8x7b_config(n_layer=2)
    p_gpu, p_cpu = two_copies(mcfg2)
    prompt20m = [(i * 7919) % mcfg.n_vocab for i in range(2, 22)]
    path_check("Mixtral widths", mcfg2, p_gpu, p_cpu, [
        ("kv dense", "dense", {}, prompt20m, ("qmv_id", "qgemm_id"), "stacked")],
        [11, 12345, 777, 31000], 33)
    # the B-row engine at Mixtral widths: each row prefill takes the grouped
    # GEMM (K11: 64, 64 and 256 (token, slot) rows), each decode step the
    # gather at 2 x 4 rows (K10)
    batched_path_check("Mixtral widths", mcfg2, p_gpu, p_cpu, "dense",
                       ("qmv_id", "qgemm_id", *dense_attn), 128,
                       [prompt20m, prompt20m[:9], [(i * 7919) % mcfg.n_vocab
                                                   for i in range(40, 73)]])
    del p_gpu, p_cpu
    torch.cuda.empty_cache()
    # Q5_K_M's Q5_K expert stacks (and Q6_K down on the more-bits layers),
    # Q3_K_M's Q3_K gate/up with Q5_K / Q4_K down, IQ2_M's IQ2_S stacks (its
    # IQ3_S down takes the first n_layer / 8 layers: none of 2) with an IQ2_S
    # attn_q + Q4_K attn_k/attn_v launch, and IQ3_XXS's IQ3_XXS stacks (IQ2_S
    # attn_q + Q8_0 attn_k/attn_v) as an f32 model: in bf16 this synthetic
    # model's own plain path moves past TOL_PATH under noise of about a bf16
    # rounding on its products (tools/path_sensitivity.py at eps 1e-3:
    # 5.6e-2, 4.5e-2 with the dense products alone perturbed; Q5_K_M 2.3e-2,
    # IQ2_M 4.8e-3), so a bf16 comparison cannot tell a kernel defect from
    # that sensitivity; in f32
    # the paths differ by summation order alone (the K10 route serves f32
    # prefill rows; K11's IQ3_XXS stacks are held in phase 3 and run in the
    # Mixtral IQ3_XXS run of phase 5)
    # and TQ1_0's ternary stacks and TQ1_0 attn_q + Q8_0 attn_k/attn_v (base-3
    # digits in llama.cpp's irregular element order)
    for preset, dtype in (("Q5_K_M", torch.bfloat16), ("Q3_K_M", torch.bfloat16),
                          ("IQ2_M", torch.bfloat16), ("IQ3_XXS", torch.float32),
                          ("TQ1_0", torch.bfloat16)):
        p_gpu, p_cpu = two_copies(mcfg2, preset)
        bf16 = dtype == torch.bfloat16
        path_check("Mixtral widths", mcfg2, p_gpu, p_cpu, [
            (f"{preset} kv dense{'' if bf16 else ' f32'}", "dense", {}, prompt20m,
             ("qmv_id", "qgemm_id") if bf16 else ("qmv", "qmv_id"), "stacked", dtype)],
            [11, 12345, 777, 31000], 33)
        del p_gpu, p_cpu
        torch.cuda.empty_cache()
    phase_s["phase 4"] = time.perf_counter() - t0
    log(f"[path] done in {phase_s['phase 4']:.1f}s")

    # 5. the synthetic Q4_K_M models through the engine
    def main_path_runs(model, params, cfgm, runs):
        """For each run (name, kv type, environment, prompt length, the
        kernels it launches — and no other; optionally max_seq and the
        number of greedy tokens, else 1024 and N_DECODE) in turn (host time
        drifts within a process): TTFT of the prompt, the capture of the
        decode step's graph for the run's kv_cap bucket, then the counted
        run, the prompt's prefill and the greedy tokens replayed from the
        graph, with every kernel's launches; for the first run of a name in
        EAGER_TURNS the same decode run eagerly in turns with the graph.
        Returns per run name the last such run's launches (prefill, decode,
        total) and tokens."""
        Vm = cfgm.n_vocab
        bound_ms = sum_wire_bytes(params, cfgm) / HBM_BYTES_PER_S * 1e3
        out = {}
        for i, (name, kv_type, env, prompt_len, used, *sizes) in enumerate(runs):
            max_seq, n_tok = sizes or (1024, N_DECODE)
            prompt = [(j * 31337) % Vm for j in range(prompt_len)]
            tag = f"[{model} {name} run {i + 1}]"
            with env_vars(env):
                eng = Engine(params, cfgm, batch_size=1, max_seq=max_seq, kv_type=kv_type)
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

                def decode(run_tokens):
                    eng.reset()
                    first = int(eng.prefill(prompt).argmax())
                    t1 = time.perf_counter()
                    toks = run_tokens([first], n_tok)
                    return toks, time.perf_counter() - t1

                # capture the step's graph for the run's kv_cap bucket first:
                # its eager warm-up step launches kernels the counted run
                # must not count
                t1 = time.perf_counter()
                decode(eng.decode_greedy_tokens)
                t_capture = time.perf_counter() - t1
                kv_cap = eng._kv_cap(prompt_len + n_tok + 1)
                captured = eng.decoder.graphs[kv_cap][1]
                # the main-path run whose launches are counted: prefill + greedy decode
                eng.reset()
                torch.cuda.reset_peak_memory_stats()
                build.reset_launches()
                logits = eng.prefill(prompt)
                prefill_launches = dict(build.LAUNCHES)
                t1 = time.perf_counter()
                toks = eng.decode_greedy_tokens([int(logits.argmax())], n_tok)
                dt = time.perf_counter() - t1
                launches = dict(build.LAUNCHES)
                peak = torch.cuda.max_memory_allocated()
                check(logits.shape == (Vm,)
                      and bool(torch.isfinite(torch.from_numpy(logits)).all()),
                      f"{tag} prefill logits not finite of the expected shape")
                check(toks.shape == (1, n_tok) and 0 <= toks.min() and toks.max() < Vm,
                      f"{tag} greedy tokens out of shape or range")
                decode_launches = {k: launches[k] - prefill_launches[k] for k in launches}
                log(f"{tag} KV cache {kv_bytes / 1e6:.1f} MB at max_seq {max_seq}")
                log(f"{tag} TTFT {ttft * 1e3:.2f} ms (median of 3 prefills of {prompt_len} "
                    f"tokens; all: {', '.join(f'{t * 1e3:.2f}' for t in ttfts)} ms)")
                log(f"{tag} decode {n_tok} tokens at depth {prompt_len}-{prompt_len + n_tok} "
                    f"in {dt:.3f}s: {n_tok / dt:.2f} tokens/s, {dt / n_tok * 1e3:.3f} "
                    f"ms/token (graph replays); weight-stream bound {bound_ms:.3f} ms/token")
                log(f"{tag} decode graph of kv_cap {kv_cap}: {sum(captured.values())} launches "
                    f"a token ({json.dumps(captured)}) x {n_tok} replays; prefill, eager "
                    f"warm-up step, capture and decode {t_capture:.3f}s")
                log(f"{tag} launches: prefill {json.dumps(prefill_launches)}, "
                    f"decode {json.dumps(decode_launches)}")
                log(f"{tag} peak device memory {peak / 2**30:.2f} GiB")
                missing = [k for k in used if launches[k] == 0]
                check(not missing, f"{tag} kernels never launched on the main path: {missing}")
                stray = [k for k in launches if k not in used and launches[k] != 0]
                check(not stray, f"{tag} kernels of another path launched: {stray}")
                want = {k: captured.get(k, 0) * n_tok for k in launches}
                check(decode_launches == want, f"{tag} decode launches {decode_launches} are not "
                      f"the captured {captured} x {n_tok} replays")
                prev = out.get(name, {})
                out[name] = {"prefill": prefill_launches, "decode": decode_launches,
                             "total": launches, "tokens": toks,
                             "ttft": ttfts[1:] + prev.get("ttft", []),
                             **{k: prev[k] for k in ("graph_ms", "eager_ms") if k in prev}}
                if (model, name) in EAGER_TURNS and "graph_ms" not in prev:
                    # graph (the counted run above), eager, eager, graph
                    ms = {"graph": [dt / n_tok * 1e3], "eager": []}
                    for way, run_tokens in (("eager", eng.decode_greedy_tokens_eager),
                                            ("eager", eng.decode_greedy_tokens_eager),
                                            ("graph", eng.decode_greedy_tokens)):
                        got, t = decode(run_tokens)
                        ms[way].append(t / n_tok * 1e3)
                        check(bool((got == toks).all()), f"{tag} {way} tokens {got[0, :8]} "
                              f"differ from the graph's {toks[0, :8]}")
                    log(f"{tag} decode ms/token in turns (graph, eager, eager, graph): graph "
                        f"{', '.join(f'{t:.3f}' for t in ms['graph'])}; eager "
                        f"{', '.join(f'{t:.3f}' for t in ms['eager'])}; the {n_tok} tokens of "
                        "all four equal")
                    out[name].update(graph_ms=ms["graph"], eager_ms=ms["eager"])
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

    def sampled_runs(params, cfgm, seed=1234, n_tok=32):
        """The CLI's loop on the card: a SamplerChain with a fixed seed and
        the CLI's default sampling draws each token from one decode_one
        (one graph replay), twice; the two runs must draw the same tokens."""
        prompt = [(j * 31337) % cfgm.n_vocab for j in range(PROMPT_LEN)]
        eng = Engine(params, cfgm, batch_size=1, max_seq=1024)
        drawn = []
        for _ in range(2):
            eng.reset()
            chain = SamplerChain(SamplerParams(seed=seed), n_vocab=cfgm.n_vocab)
            logits = eng.prefill(prompt)
            toks = []
            t1 = time.perf_counter()
            for _ in range(n_tok):
                tok = chain.sample(logits)
                chain.accept(tok)
                toks.append(tok)
                logits = eng.decode_one([tok])[0]
            dt = time.perf_counter() - t1
            check(bool(torch.isfinite(torch.from_numpy(logits)).all()),
                  "sampled run: logits not finite")
            drawn.append(toks)
            log(f"[8b sampled] {n_tok} tokens (seed {seed}, temp 0.8, top-k 40, top-p 0.95, "
                f"min-p 0.05) through decode_one in {dt:.3f}s, {dt / n_tok * 1e3:.3f} ms/token "
                f"with the sampler: {toks[:12]}")
        check(drawn[0] == drawn[1], f"sampled runs differ: {drawn[0]} != {drawn[1]}")
        log(f"[8b sampled] the two runs drew the same {n_tok} tokens "
            f"({len(set(drawn[0]))} distinct)")
        del eng
        torch.cuda.empty_cache()

    def graph_edges(raw_graph) -> dict:
        """{"nodes": n, "edges": {type: count}} of a captured cudaGraph_t
        (type 0 the full dependency, 1 programmatic), through the CUDA
        runtime that PyTorch loaded."""
        import ctypes
        try:
            rt = ctypes.CDLL("libcudart.so.12")
        except OSError:
            rt = ctypes.CDLL(str(Path(build.nvcc()).parents[1] / "lib64" / "libcudart.so"))
        n = ctypes.c_size_t(0)
        check(rt.cudaGraphGetEdges_v2(ctypes.c_void_p(raw_graph), None, None, None,
                                      ctypes.byref(n)) == 0, "cudaGraphGetEdges_v2 failed")
        src, dst = (ctypes.c_void_p * n.value)(), (ctypes.c_void_p * n.value)()
        data = (ctypes.c_uint8 * (8 * n.value))()  # cudaGraphEdgeData: 8 bytes, type at 2
        check(rt.cudaGraphGetEdges_v2(ctypes.c_void_p(raw_graph), src, dst, data,
                                      ctypes.byref(n)) == 0, "cudaGraphGetEdges_v2 failed")
        nodes = ctypes.c_size_t(0)
        rt.cudaGraphGetNodes(ctypes.c_void_p(raw_graph), None, ctypes.byref(nodes))
        types = {}
        for e in range(n.value):
            types[data[8 * e + 2]] = types.get(data[8 * e + 2], 0) + 1
        return {"nodes": nodes.value, "edges": types}

    def pdl_under_capture():
        """K4 and K6 (a split kernel, then the combine as a programmatic
        dependent launch) captured alone: the edge between the two in the
        graph, and the replay's output against the eager call's."""
        L, S, D, H, Hkv = 2, 1024, cfg.head_dim_k, cfg.n_head, cfg.n_head_kv
        q, kc, vc = rnd(1, H, D), rnd(1, Hkv, D), rnd(1, Hkv, D)
        n = torch.tensor([1000], dtype=torch.int32, device=dev)
        qc = QuantKVCache.create(L, 1, S, Hkv, D, D, kinds=("q8_0", "q8_0"), device=dev)
        qc.write_all(rnd(L, 1, S, Hkv, D), rnd(L, 1, S, Hkv, D), torch.zeros(1, dtype=torch.int32,
                                                                           device=dev))
        ks, vs = rnd(L, 1, S, Hkv, D), rnd(L, 1, S, Hkv, D)
        calls = {
            "K4 flash_decode_dense": lambda: flash_decode_stacked_dense(
                q, ks, vs, 1, kc, vc, n, D**-0.5),
            "K6 flash_decode_quant": lambda: flash_decode_stacked(
                q, qc.k_planes, qc.v_planes, 1, kc, vc, n, D**-0.5, kinds=qc.kinds)}
        for what, fn in calls.items():
            eager = fn()
            try:
                graph, kept = torch.cuda.CUDAGraph(keep_graph=True), True
            except TypeError:
                graph, kept = torch.cuda.CUDAGraph(), False
            with build.capturing_launches():
                with torch.cuda.graph(graph):
                    got = fn()
            edges = (graph_edges(graph.raw_cuda_graph()) if kept
                     else "not inspected (this torch keeps no captured graph)")
            graph.replay()
            torch.cuda.synchronize()
            same = bool(torch.equal(got, eager))
            log(f"[graph] {what} captured alone: {edges} (edge type 1 = programmatic: the "
                f"combine's early launch is kept); replay equals the eager call bit for bit: "
                f"{same}")
            check(same, f"{what}: the captured split + combine differs from the eager call")
    def http_post(url, body, stream=False):
        """POST a JSON body: the reply's JSON, or with stream the SSE
        messages' JSON up to [DONE]."""
        import urllib.request
        req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as r:
            if not stream:
                return json.loads(r.read())
            msgs = []
            for line in r:
                line = line.decode().strip()
                if line == "data: [DONE]":
                    return msgs
                if line.startswith("data: "):
                    msgs.append(json.loads(line[6:]))
        return msgs

    def post_all(url, bodies):
        """The bodies POSTed at once, one client thread each, started 50 ms
        apart so that the server queues them in order (the slots they take
        and the prefixes they reuse then follow from the order); the replies
        in order, and the wall time until the last came back."""
        out = [None] * len(bodies)

        def go(i, body):
            try:
                out[i] = http_post(url + "/completion", body, stream=bool(body.get("stream")))
            except Exception as e:  # the check below fails the phase on it
                out[i] = {"error": repr(e)}

        threads = [threading.Thread(target=go, args=(i, b)) for i, b in enumerate(bodies)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
            time.sleep(0.05)
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        check(not any(t.is_alive() for t in threads), "a serving request did not return")
        for i, r in enumerate(out):
            final = r[-1] if isinstance(r, list) else r
            check(isinstance(final, dict) and "error" not in final
                  and not any("error" in m for m in (r if isinstance(r, list) else [r])),
                  f"serving request {i}: error reply {final}")
        return out, wall

    def served(tag, model, run_requests, **server_kw):
        """A ServerContext on the card served over HTTP on 127.0.0.1 (a port
        the OS picks). A short warm-up request first captures the decode
        graph; then the launches are counted over run_requests(url): every
        decode step must be a replay (the launches of the decode steps, all
        launches less those of the prefills, are the captured ones times
        the replays; the step function runs no time outside a graph), and
        the SIMT bodies of K5 and K7 never launch. Returns (the requests'
        result, the launches, the server's metrics, peak device memory)."""
        from llamacog_tpu_torch.server.server import serve

        ctx, httpd = serve(model, host="127.0.0.1", port=0, **server_kw)
        th = threading.Thread(target=httpd.serve_forever, daemon=True)
        th.start()
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            post_all(url, [{"prompt": list(range(300, 364)), "n_predict": 4,
                            "temperature": 0.0, "ignore_eos": True}])
            eng = ctx.engine
            counts = {"steps": 0, "replays": {}, "prefill": dict.fromkeys(build.LAUNCHES, 0),
                      "decode_s": 0.0, "decodes": 0, "rows": 0, "prefill_s": 0.0,
                      "shift_s": 0.0}
            step, run, prefill = eng.decoder.step, eng.decoder.run, eng.prefill
            decode_one, shift_row = eng.decode_one, eng.shift_row

            def timed_decode_one(toks, active=None):
                t0 = time.perf_counter()
                out = decode_one(toks, active=active)
                counts["decode_s"] += time.perf_counter() - t0
                counts["decodes"] += 1
                counts["rows"] += int(np.sum(active)) if active is not None else len(toks)
                return out

            def timed_shift_row(*a):
                t0 = time.perf_counter()
                shift_row(*a)
                counts["shift_s"] += time.perf_counter() - t0

            def counted_step(*a, **kw):
                counts["steps"] += 1
                return step(*a, **kw)

            def counted_run(fwd, kv_cap, n):
                counts["replays"][kv_cap] = counts["replays"].get(kv_cap, 0) + n
                return run(fwd, kv_cap, n)

            def counted_prefill(ids, row=0):
                before = dict(build.LAUNCHES)
                t0 = time.perf_counter()
                out = prefill(ids, row=row)
                counts["prefill_s"] += time.perf_counter() - t0
                for k, v in build.LAUNCHES.items():
                    counts["prefill"][k] = counts["prefill"].get(k, 0) + v - before.get(k, 0)
                return out

            eng.decoder.step, eng.decoder.run, eng.prefill = counted_step, counted_run, \
                counted_prefill
            eng.decode_one, eng.shift_row = timed_decode_one, timed_shift_row
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            build.reset_launches()
            t_run = time.perf_counter()
            result = run_requests(url)
            t_run = time.perf_counter() - t_run
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            total = dict(build.LAUNCHES)
            metrics = dict(ctx.metrics)
            decode = {k: v - counts["prefill"].get(k, 0) for k, v in total.items()}
            captured = {cap: g[1] for cap, g in eng.decoder.graphs.items()}
            want = {k: sum(captured.get(cap, {}).get(k, 0) * n
                           for cap, n in counts["replays"].items()) for k in total}
            log(f"[{tag}] decode graphs (kv_cap: replays) {counts['replays']}, captured "
                f"launches a step {json.dumps(captured)}"
                f"; launches: prefill {json.dumps({k: v for k, v in counts['prefill'].items() if v})}"
                f", decode {json.dumps({k: v for k, v in decode.items() if v})}")
            check(decode == want, f"[{tag}] decode launches {decode} are not the captured ones "
                  f"times the replays {want}")
            n = max(counts["decodes"], 1)
            log(f"[{tag}] where the time goes, {t_run:.3f}s on the host clock: {counts['decodes']}"
                f" decode steps (decode_one: the graph replay and the logits' copy to the "
                f"host) {counts['decode_s']:.3f}s, {counts['decode_s'] / n * 1e3:.3f} ms a step "
                f"for {counts['rows'] / n:.2f} active rows; prefill chunks "
                f"{counts['prefill_s']:.3f}s; context shifts {counts['shift_s']:.3f}s; the rest "
                f"(the samplers and grammars, emission, HTTP, the loop) "
                f"{t_run - counts['decode_s'] - counts['prefill_s'] - counts['shift_s']:.3f}s")
            check(counts["steps"] == 0, f"[{tag}] the decode step ran {counts['steps']} times "
                  "outside a graph replay")
            check(total["flash_prefill_simt"] == 0 and total["flash_prefill_quant_simt"] == 0,
                  f"[{tag}] a SIMT body launched: {total}")
        finally:
            httpd.shutdown()
            httpd.server_close()
            ctx.stop()
            th.join(timeout=60)
        check(not th.is_alive() and not ctx.thread.is_alive(), f"[{tag}] server threads run on")
        return result, total, metrics, peak

    def serving_runs(params, cfgm, single_ms):
        """Phase 5's serving run: the 8B through the port's server on the
        card, SERVING_SLOTS slots and ctx 4096, 8 requests at once with
        prompts of 128-1024 tokens drawn from --seed (token ids; a synthetic
        Llama-3-sized vocab detokenizes), four of them sharing a 512-token
        prefix; then one request past a 512-token context on one slot, with
        the dense and the q8_0 cache. Returns the launches of each run."""
        from llamacog_tpu_torch.models.loader import Model
        from llamacog_tpu_torch.runtime.grammar import grammar_from_gbnf
        from llamacog_tpu_torch.runtime.json_schema import json_schema_to_gbnf
        from llamacog_tpu_torch.server.server import PREFILL_CHUNK
        from llamacog_tpu_torch.utils.synthetic import synthetic_vocab

        t_phase = time.perf_counter()
        Vm = cfgm.n_vocab
        vocab = synthetic_vocab(Vm)
        model = Model(cfgm, params, vocab, None)
        rng = np.random.default_rng(SEED)
        kinds = ("greedy", "greedy", "sampled", "greedy", "greedy", "sampled", "stream",
                 "schema")
        # requests 0 and 1 fill slots 0 and 1 first and finish first; 4 and 5
        # then take those slots by the prefix rule and reuse the prefix
        share = {0, 1, 4, 5}
        prefix = rng.integers(256, 128000, size=512).tolist()
        prompts = []
        for i, n in enumerate(rng.integers(128, 1025, size=len(kinds)).tolist()):
            if i in share:
                suffix = rng.integers(256, 128000, size=max(n, 520) - 512).tolist()
                suffix[0] = 256 + i  # the shared prefix ends at 512 exactly
                prompts.append(prefix + suffix)
            else:
                prompts.append(rng.integers(256, 128000, size=n).tolist())
        log(f"[serving] seed {SEED}: prompts of {[len(p) for p in prompts]} tokens "
            f"({', '.join(kinds)}); requests {sorted(share)} share a 512-token prefix; "
            f"prefill chunks of {PREFILL_CHUNK}")

        # the single-stream reference of each greedy request: an
        # Engine(batch_size=1) fed the chunks the slot is fed (a prefix reused
        # at 512 is the first chunk), then decode_one steps, the top-2 logits
        # of each kept
        ref = {}
        eng1 = Engine(params, cfgm, batch_size=1, max_seq=4096)
        for i, kind in enumerate(kinds):
            if kind not in ("greedy", "stream"):
                continue
            p = prompts[i]
            for off in range(0, len(p), PREFILL_CHUNK):
                logits = eng1.prefill(p[off:off + PREFILL_CHUNK])
            toks, top2 = [], []
            t1 = time.perf_counter()
            for j in range(N_SERVE):
                lt = logits.reshape(-1).copy()
                first = int(np.argmax(lt))  # the server's greedy pick: the first maximum
                top1 = float(lt[first])
                lt[first] = -np.inf
                second = int(np.argmax(lt))
                toks.append(first)
                top2.append((top1, float(lt[second]), second))
                if j + 1 < N_SERVE:
                    logits = eng1.decode_one([toks[-1]])[0]
            ref[i] = {"tokens": toks, "top2": top2,
                      "ms": (time.perf_counter() - t1) / (N_SERVE - 1) * 1e3}
            eng1.reset()
        del eng1
        torch.cuda.empty_cache()
        # the streamed request's stop string: the text of three plain tokens
        # of its reference, the last window whose text occurs there first
        # (the random model soon repeats one token: then the window of its
        # first three repeats, so the tokens before stream and the first two
        # repeats are held back)
        stream_i = kinds.index("stream")
        rtoks = ref[stream_i]["tokens"]
        pieces = [vocab.token_to_piece(t).decode("utf-8", "replace") for t in rtoks]
        rtext = "".join(pieces)
        starts = np.cumsum([0] + [len(p) for p in pieces]).tolist()
        windows = [j for j in range(N_SERVE - 2) if all(256 <= t < 128000 for t in rtoks[j:j + 3])
                   and rtext.find("".join(pieces[j:j + 3])) == starts[j]]
        check(bool(windows), f"serving: no stop string in the streamed reference {rtoks}")
        stop_j = windows[-1]
        stop = "".join(pieces[stop_j:stop_j + 3])
        schema = {"type": "object", "properties": {"ok": {"type": "boolean"}},
                  "required": ["ok"]}
        bodies = []
        for i, kind in enumerate(kinds):
            b = {"prompt": prompts[i], "n_predict": N_SERVE, "ignore_eos": True,
                 "return_tokens": True, "temperature": 0.0}
            if kind == "sampled":
                b.update(temperature=0.8, seed=42 + i)
            elif kind == "stream":
                b.update(stream=True, stop=[stop])
            elif kind == "schema":
                b.update(json_schema=schema, n_predict=256, seed=42 + i, ignore_eos=False)
            bodies.append(b)

        def batch(url):
            out, wall = post_all(url, bodies)
            again, _ = post_all(url, [bodies[i] for i, k in enumerate(kinds) if k == "sampled"])
            return out, wall, again

        (out, wall, again), launches, metrics, peak = served(
            "serving", model, batch, n_slots=SERVING_SLOTS, ctx_size=4096)
        finals = [r[-1] if isinstance(r, list) else r for r in out]
        n_gen = sum(f["tokens_predicted"] for f in finals)
        for i, (kind, f) in enumerate(zip(kinds, finals)):
            t = f["timings"]
            log(f"[serving] request {i} ({kind}, {len(prompts[i])} prompt tokens, "
                f"{t['cache_n']} reused): TTFT {t['prompt_ms']:.2f} ms from admission, "
                f"{f['tokens_predicted']} tokens at "
                f"{t['predicted_ms'] / max(f['tokens_predicted'], 1):.3f} ms/token, "
                f"stop {f['stop_reason']}")
            check(t["cache_n"] in (0, 512), f"serving request {i}: {t['cache_n']} prompt "
                  "tokens reused, not 0 or the 512-token prefix")
        log(f"[serving] {len(kinds)} requests, {n_gen} generated tokens in {wall:.3f}s: "
            f"{n_gen / wall:.2f} tokens/s aggregate; single stream (the 8B dense run's "
            f"graph loop) {1e3 / single_ms:.2f} tokens/s; prompt tokens "
            f"{metrics['prompt_tokens_total']} prefilled, "
            f"{metrics.get('prompt_tokens_cached_total', 0)} reused; peak device memory "
            f"{peak / 2**30:.2f} GiB; {nvidia_smi_line()}")
        check(metrics.get("prompt_tokens_cached_total", 0) > 0,
              "serving: no prompt prefix was reused (prompt_tokens_cached_total 0)")
        # greedy requests: the single-stream tokens, or a tie where they part
        for i, r in ref.items():
            got = finals[i]["tokens"]
            want = r["tokens"][:len(got)]
            part = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), None)
            if part is None:
                log(f"[serving] request {i}: its {len(got)} tokens equal the single-stream "
                    f"tokens ({r['ms']:.3f} ms/token through decode_one)")
            else:
                top1, top2, second = r["top2"][part]
                ulp = 2.0 ** (torch.frexp(torch.tensor(top1)).exponent.item() - 8)
                gap = (top1 - top2) / ulp
                log(f"[serving] request {i}: parts from single stream at token {part}: server "
                    f"{got[part]}, single stream {want[part]} (its second {second}), top-2 "
                    f"gap {gap:.2f} bf16 ulps")
                check(gap <= TIE_ULPS, f"serving request {i}: greedy tokens part from the "
                      f"single stream at {part} with a top-2 gap of {gap:.2f} bf16 ulps")
            check(kinds[i] == "stream" or len(got) == N_SERVE,
                  f"serving request {i}: {len(got)} tokens, not {N_SERVE}")
        # the streamed request stops before its stop string, having held it back
        f, msgs = finals[stream_i], out[stream_i]
        streamed = "".join(m["content"] for m in msgs[:-1]) + f["content"]
        if f["tokens"][:stop_j + 3] == rtoks[:stop_j + 3]:
            check(streamed == rtext[:starts[stop_j]] and f["tokens_predicted"] == stop_j + 3,
                  f"serving stream: {f['tokens_predicted']} tokens, text not the single "
                  f"stream's up to the stop string {stop!r}")
        check(stop not in streamed, f"serving stream: the stop string {stop!r} was streamed")
        log(f"[serving] streamed request: stop string {stop!r} (tokens {stop_j}-{stop_j + 2}); "
            f"{len(msgs) - 1} chunks, {len(streamed)} characters, {f['tokens_predicted']} "
            f"tokens, stop {f['stop_reason']}")
        # the seeded requests draw the same text when sent again
        firsts = [finals[i] for i, k in enumerate(kinds) if k == "sampled"]
        for a, b in zip(firsts, again):
            check(a["content"] == b["content"] and a["tokens"] == b["tokens"],
                  "serving: a seeded request drew other tokens when sent again")
        log("[serving] the two seeded requests, sent again, drew the same tokens")
        # every token of the schema reply is one the grammar accepts
        f = finals[kinds.index("schema")]
        gram = grammar_from_gbnf(json_schema_to_gbnf(schema), vocab)
        for j, t in enumerate(f["tokens"]):
            check(gram.accepts_token(t), f"serving schema: token {j} ({t}) not accepted by "
                  "the schema's grammar")
            gram.accept_token(t)
        if f["stop_reason"] == "eos":
            doc = json.loads(f["content"])
            check(isinstance(doc, dict) and isinstance(doc.get("ok"), bool),
                  f"serving schema: {f['content']!r} does not match the schema")
        log(f"[serving] schema request: {f['tokens_predicted']} tokens, every one accepted by "
            f"the grammar, stop {f['stop_reason']}: {f['content']!r}")
        runs = {"serving": {"total": launches}}
        # one request past a 512-token context on one slot, dense and q8_0
        for kv in ("dense", "q8_0"):
            body = {"prompt": rng.integers(256, 128000, size=128).tolist(), "n_predict": 600,
                    "temperature": 0.0, "ignore_eos": True}

            def one(url):
                out, wall = post_all(url, [body])
                return out[0], wall

            (res, wall), launches, metrics, peak = served(
                f"shift {kv}", model, one, n_slots=1, ctx_size=512, kv_type=kv)
            shifts = metrics.get("context_shifts_total", 0)
            log(f"[serving] shift run, kv {kv}: 1 slot, ctx 512, a 128-token prompt, "
                f"{res['tokens_predicted']} tokens in {wall:.3f}s "
                f"({res['tokens_predicted'] / wall:.2f} tokens/s), {shifts} context shifts, "
                f"peak device memory {peak / 2**30:.2f} GiB")
            check(res["tokens_predicted"] == 600 and shifts >= 1,
                  f"shift run {kv}: {res['tokens_predicted']} tokens, {shifts} shifts")
            runs[f"shift {kv}"] = {"total": launches}
        log(f"[serving] phase wall time {time.perf_counter() - t_phase:.1f}s")
        return runs

    def build_params(model, cfgm, ftype=DEFAULT_LAYOUT):
        t0 = time.perf_counter()
        params = make_synthetic_params(cfgm, seed=0, ftype=ftype,
                                       imatrix=ftype in CODEBOOK_PRESETS)
        torch.cuda.synchronize()
        kinds = sorted({f"{k} {v.kind}" for k, v in params["layers"][0].items()
                        if isinstance(v, WireTensor)})
        log(f"[{model}] synthetic {ftype} params ({cfgm.n_layer} layers) built in "
            f"{time.perf_counter() - t0:.1f}s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB; "
            f"layer 0 weights {', '.join(kinds)}")
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

    # the kernels each run launches (and it launches no other): K5 and K7 by
    # their tensor-core tiles alone, never their SIMT bodies
    # (flash_prefill_simt, flash_prefill_quant_simt); dense_attn and
    # quant_attn are set before phase 4
    moe_kernels = ("qmv_id", "qgemm_id")
    exact_path = ("qmv", "qgemm", *dense_attn)
    mmq_env, k9_env = {"LLAMACOG_MMQ": "1"}, {"LLAMACOG_FLASH_STACKED": "0",
                                              "LLAMACOG_FLASH_DECODE": "1"}
    t5 = time.perf_counter()
    pdl_under_capture()
    params = build_params("8b", cfg)
    runs_8b = main_path_runs("8b", params, cfg, [
        ("kv dense", "dense", {}, PROMPT_LEN, exact_path),
        ("kv q8_0", "q8_0", {}, PROMPT_LEN, ("qmv", "qgemm", *quant_attn)),
        ("kv q8_0", "q8_0", {}, PROMPT_LEN, ("qmv", "qgemm", *quant_attn)),
        ("kv dense", "dense", {}, PROMPT_LEN, exact_path),
        # a 512-token prompt, exact and int8 prefill (LLAMACOG_MMQ=1)
        ("exact 512", "dense", {}, 512, exact_path),
        ("mmq 512", "dense", mmq_env, 512, ("qmv", "qmm_i8", "quantize_i8", *dense_attn)),
        ("mmq 512", "dense", mmq_env, 512, ("qmv", "qmm_i8", "quantize_i8", *dense_attn)),
        ("exact 512", "dense", {}, 512, exact_path),
        # the per-layer dense decode route (K9)
        ("per-layer K9", "dense", k9_env, PROMPT_LEN, ("qmv", "qgemm", "flash_decode",
                                                       "flash_prefill")),
        # long context: a 4096-token prompt in two 2048-token chunks (the
        # second attends a 2048-deep old cache), 64 tokens at depth 4096+
        ("long 4096", "dense", {}, LONG_PROMPT, exact_path, 8192, 64),
        # the q8_0 cache at depth: a 2048-token prompt in one chunk (K7 at
        # offset 0), 64 tokens at depth 2048-2112 (kv_cap 4096)
        ("q8_0 2048", "q8_0", {}, 2048, ("qmv", "qgemm", *quant_attn), 4096, 64),
        # and a 4096-token prompt in two 2048-token chunks (the second's K7
        # dequantizes a 2048-deep old cache), 16 tokens at depth 4096+
        ("q8_0 4096", "q8_0", {}, LONG_PROMPT, ("qmv", "qgemm", *quant_attn), 8192, 16),
    ])
    n_l = cfg.n_layer
    mmq_run, k9_run = runs_8b["mmq 512"], runs_8b["per-layer K9"]
    long_run, deep_q8 = runs_8b["long 4096"], runs_8b["q8_0 2048"]
    check(deep_q8["decode"]["flash_decode_quant"] == 64 * n_l,
          f"q8_0 2048 run: decode flash_decode_quant {deep_q8['decode']['flash_decode_quant']} "
          f"(want {64 * n_l})")
    # K7 by its tiles, one launch a layer and chunk, in every q8_0 run (the
    # SIMT body is a stray: main_path_runs fails a run that launches it)
    for name, chunks in (("kv q8_0", 1), ("q8_0 2048", 1), ("q8_0 4096", 2)):
        got = runs_8b[name]["prefill"]["flash_prefill_quant"]
        check(got == chunks * n_l and runs_8b[name]["total"]["flash_prefill_quant_simt"] == 0,
              f"{name} run: prefill flash_prefill_quant {got} (want {chunks * n_l}), "
              f"flash_prefill_quant_simt {runs_8b[name]['total']['flash_prefill_quant_simt']}")
    check(long_run["prefill"]["flash_prefill"] == 2 * n_l
          and long_run["decode"]["flash_decode_dense"] == 64 * n_l,
          f"long run: prefill flash_prefill {long_run['prefill']['flash_prefill']} (want "
          f"{2 * n_l}), decode flash_decode_dense {long_run['decode']['flash_decode_dense']} "
          f"(want {64 * n_l})")
    # int8 prefill: one quantization a layer input (qk+v, output, gate_up,
    # down) and K13 for each of the five weights
    check(mmq_run["prefill"]["qmm_i8"] == 5 * n_l and mmq_run["prefill"]["qgemm"] == 0
          and mmq_run["prefill"]["quantize_i8"] == 4 * n_l
          and mmq_run["decode"]["qmm_i8"] == 0 and mmq_run["decode"]["quantize_i8"] == 0,
          f"mmq run: prefill qmm_i8 {mmq_run['prefill']['qmm_i8']} (want {5 * n_l}), "
          f"quantize_i8 {mmq_run['prefill']['quantize_i8']} (want {4 * n_l}), qgemm "
          f"{mmq_run['prefill']['qgemm']} (want 0), decode qmm_i8 {mmq_run['decode']['qmm_i8']}"
          f" quantize_i8 {mmq_run['decode']['quantize_i8']} (want 0)")
    check(k9_run["decode"]["flash_decode"] == n_l * N_DECODE
          and k9_run["total"]["flash_decode_dense"] == 0,
          f"K9 run: flash_decode {k9_run['decode']['flash_decode']} (want {n_l * N_DECODE}), "
          f"flash_decode_dense {k9_run['total']['flash_decode_dense']} (want 0)")
    ttft = {name: statistics.median(runs_8b[name]["ttft"]) * 1e3
            for name in ("exact 512", "mmq 512")}
    log(f"[8b] 512-token prompt TTFT, median of both runs' prefills: exact "
        f"{ttft['exact 512']:.2f} ms, LLAMACOG_MMQ=1 {ttft['mmq 512']:.2f} ms")
    same = bool((k9_run["tokens"] == runs_8b["kv dense"]["tokens"]).all())
    log(f"[8b] per-layer K9 run: {N_DECODE} greedy tokens equal the stacked dense run's: {same}")
    check(same, "the per-layer K9 route's greedy tokens differ from the stacked route's")
    sampled_runs(params, cfg)
    single_ms = statistics.median(runs_8b["kv dense"]["graph_ms"])
    serving = serving_runs(params, cfg, single_ms)
    del params
    torch.cuda.empty_cache()

    def preset_run(model, cfgm, preset, used):
        """The synthetic model of `preset` at cfgm's depth through the engine:
        a 128-token prompt, 64 greedy tokens through the graph (main_path_runs).
        The kinds phase 3 reads this run's launches for (KIND_PRESET for the
        8B, EXPERT_PRESET for Mixtral's stacks) must be among its weights."""
        params = build_params(f"{model} {preset}", cfgm, preset)
        stacks = model == "mixtral"
        held = {w.kind for layer in params["layers"] for w in layer.values()
                if isinstance(w, WireTensor) and (len(w.shape) == 3) == stacks}
        claimed = {k for k, p in (EXPERT_PRESET if stacks else KIND_PRESET).items() if p == preset}
        check(claimed <= held, f"{model} {preset}: the run holds {sorted(held)} "
              f"{'expert stacks' if stacks else 'layer weights'}, not {sorted(claimed - held)}")
        run = main_path_runs(f"{model} {preset}", params, cfgm,
                             [(preset, "dense", {}, PROMPT_LEN, used, 1024, 64)])[preset]
        log(f"[{model} {preset}] the run's {'expert stacks' if stacks else 'layer weights'}: "
            f"{sorted(held)}; phase 3 reads its launches for {sorted(claimed)}")
        del params
        torch.cuda.empty_cache()
        return run

    # the 8B at full depth in each preset that holds one of the other kinds
    preset_runs = {f"8b {p}": preset_run("8b", cfg, p, exact_path)
                   for p in ("Q4_0", "Q4_1", "Q5_0", "Q5_1", "Q2_K", "Q3_K_M", "IQ4_XS",
                             "IQ4_NL", "IQ3_XXS", "IQ3_M", "IQ2_M", *LOW_PRESET.values())}
    # Mixtral-8x7B at full depth (28.3 GB of wire blocks), the dense cache,
    # the attention weight kinds of a real Q4_K_M file: the MoE kernels must
    # launch, the quantized-cache ones must not
    params = build_params("mixtral", mcfg)
    moe_path = (*exact_path, *moe_kernels)
    runs_moe = main_path_runs("mixtral", params, mcfg, [
        ("kv dense", "dense", {}, PROMPT_LEN, moe_path),
        ("kv dense", "dense", {}, PROMPT_LEN, moe_path),
        # a 512-token prompt: the grouped GEMM with several tiles an expert
        ("kv dense 512", "dense", {}, 512, moe_path, 1024, 16)])
    got = runs_moe["kv dense 512"]["prefill"]["qgemm_id"]
    check(got == 2 * mcfg.n_layer, f"mixtral 512 run: prefill qgemm_id {got} "
          f"(want {2 * mcfg.n_layer})")
    del params
    torch.cuda.empty_cache()
    # Mixtral-8x7B Q5_K_M and IQ4_XS at full depth (Q5_K, IQ4_XS expert
    # stacks), and the presets that hold each other expert kind at
    # MIXTRAL_PRESET_LAYERS layers
    mcfg_cut = mixtral_8x7b_config(n_layer=MIXTRAL_PRESET_LAYERS)
    for preset in sorted(set(EXPERT_PRESET.values()), key=lambda p: p not in MIXTRAL_FULL_DEPTH):
        preset_runs[f"mixtral {preset}"] = preset_run(
            "mixtral", mcfg if preset in MIXTRAL_FULL_DEPTH else mcfg_cut, preset, moe_path)
    # Llama-3-70B in IQ2_XXS at full depth (80 layers, ~19 GB of wire blocks):
    # the preset that puts a 70B on one card; 64 query heads over 8 kv heads
    preset_runs["70b IQ2_XXS"] = preset_run("70b", llama3_70b_config(), "IQ2_XXS", exact_path)
    log(f"[70b IQ2_XXS] on {nvidia_smi_line()}")
    for model, name in sorted(EAGER_TURNS):
        r = (runs_8b if model == "8b" else runs_moe)[name]
        log(f"[{model} {name}] decode ms/token, graph {statistics.median(r['graph_ms']):.3f} "
            f"(median of {len(r['graph_ms'])}), eager {statistics.median(r['eager_ms']):.3f} "
            f"(median of {len(r['eager_ms'])})")
    phase_s["phase 5"] = time.perf_counter() - t5
    log(f"[phase 5] wall time {phase_s['phase 5']:.1f}s")
    log("[phases] " + ", ".join(f"{k} {v:.1f}s" for k, v in phase_s.items())
        + f"; total since the build began {sum(phase_s.values()):.1f}s")

    # 6. results
    # each kernel's launches in the run of its path: the MoE kernels in the
    # Mixtral run, the quantized-cache kernels in the 8B q8_0 run, K13 in
    # the mmq run, K9 in the per-layer run, the rest in the 8B dense run
    run_of = {"qmm_i8": mmq_run, "flash_decode": k9_run,
              **{k: runs_moe["kv dense"] for k in moe_kernels},
              **{k: runs_8b["kv q8_0"] for k in quant_attn}}
    run_named = {**runs_8b, "mixtral": runs_moe["kv dense"],
                 "mixtral 512": runs_moe["kv dense 512"], **preset_runs, **serving, **rows_runs}
    for r in results:
        k, run = r.pop("kernel"), r.pop("run")
        r["launches"] = (run_named[run] if run
                         else run_of.get(k, runs_8b["kv dense"]))["total"][k]
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
    from llamacog_tpu_torch.quant.wire import (
        CODEBOOK_KINDS, LOW_BIT_KINDS, WireTensor, keep_decoded)

    total = params["output"].nbytes
    for layer in params["layers"]:
        for v in layer.values():
            if isinstance(v, WireTensor):
                total += (v.nbytes * cfg.n_expert_used // cfg.n_expert if len(v.shape) == 3
                          else v.nbytes)
    return total


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="smoke test of the PyTorch port on one GPU")
    ap.add_argument("--seed", type=int, default=SEED, help="seed of the serving run's prompts")
    SEED = ap.parse_args().seed
    sys.exit(main())
