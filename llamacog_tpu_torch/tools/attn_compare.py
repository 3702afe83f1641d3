"""The dense-cache attention kernels and the weight kernels of two versions
of the port, timed in turns on one GPU.

    python -m llamacog_tpu_torch.tools.attn_compare --baseline DIR [--iters 31]
        [--only attn|weights|quant|prefill_quant|i8|block32]

DIR is another checkout of the repository (for example an older commit
unpacked by ``git archive``); its ``llamacog_tpu_torch`` is imported under
another name and builds its own kernels into its own ``csrc/build``. At the
Llama-3-8B heads (H 32, Hkv 8, D 128, bf16) and the shapes of
``chip_smoke.py`` phase 3 — prefill K5 at T=128 over write offsets 0 and 896
and T=512 at 0 (a 1024-slot layer), decode K4 (layer 1 of a 2-layer stack)
and K9 (the same layer) at depths 1000 and 32765 — each version's wrapper
and ``scaled_dot_product_attention`` are timed in one loop, one call of
each in turn, L2 flushed before each call. The weight kernels the same way
(no library call computes them): qmv (K1, K3) at one bf16 row over the 8B
layer weights and the LM head, qgemm (K2, K3) at 128 and 512 rows over the
five layer weights, and the MoE kernels: the gather qmv_id (K10) at the
shapes chip_smoke.py's phase 3 holds (every expert kind at the Mixtral-8x7B
stacks at 2 and 32 rows, Q4_K gate_up and Q6_K down also at 16, its offset
entry (K12), 32 rows on one expert and on four, the families' stacks at one
token's and four tokens' rows) and
the grouped GEMM qgemm_id (K11) of a 128- and a 512-token prefill at the
Mixtral shapes (each tree on its own model's token tile, the same
routing); the Q8_0 and Q5_K
weights of a real Mixtral Q4_K_M file (attn_k, attn_output and the
attn_q + attn_k + attn_v launch) are timed on this tree alone where the
baseline refuses their kinds. The quantized-cache decode kernel (K6, and
K8 through its per-layer entry) the same way (``--only quant``): q8_0 and
q4_0 caches at depths 1000 (a 1024-slot layer) and 32765 (32768 slots),
layer 1 of a 2-layer stack, and the per-layer entry on that layer. The
quantized-cache prefill kernel (K7, ``--only prefill_quant``): q8_0 and
q4_0 planes, T=128 over write offsets 0 and 896 (a 1024-slot layer) and
T=2048 over 0 and 2048 (4096 slots), each beside K5 over a dense bf16
cache holding the same values (the planes dequantized and rounded to
bf16, which is what K7's tiles multiply): K7's target is K5's time on
the same work. The int8 prefill route (``--only i8``): the K13 GEMM of both
trees and ``torch._int_mm`` over the planes of the five 8B layer weights at
512 and 300 rows, and this tree's activation quantization kernel beside
the baseline's route for it (``quantize_activations``, torch ops). The
32-weight-block kinds (``--only block32``: Q4_0, Q4_1, Q5_0, Q5_1, Q8_0,
IQ4_NL) at whole 256-weight runs, which both trees take: qmv (K1) at one
row over the 8B gate_up and ffn_down, and the gather qmv_id (K10) at 2 and
32 rows over the Mixtral-8x7B gate_up and down stacks. Two
spans:

- ``enqueue``: CUDA events around the call right after the flush, the span
  of ``chip_smoke.py``'s ``ms``. Where the wrapper's host work outlasts the
  flush, the span holds part of it;
- ``device``: the card is held busy ~0.2 ms more after the flush
  (``torch.cuda._sleep``), so the call is queued before the start event
  fires: the device's time alone.

Beside them each wrapper's host time per call (a loop of calls with no
sync). Prints one line per shape and callee, the medians, and a JSON line
of all of them; each kernel's error against its plain version is checked.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import importlib
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

BASE = "baseline_llamacog_tpu_torch"
TOL_ATTN = 1e-2  # bf16 outputs, relative to the largest |reference| (chip_smoke.py)
TOL_QMM = 1e-4   # the weight kernels (chip_smoke.py)


def rel_err(got, ref) -> float:
    got, ref = got.double(), ref.double()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def load_baseline(root: Path, name: str = BASE):
    """The port package of the checkout at `root`, imported as `name`."""
    pkg = root / "llamacog_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="llamacog-attn-compare")
    ap.add_argument("--baseline", type=Path, required=True,
                    help="root of another checkout of the repository")
    ap.add_argument("--iters", type=int, default=31)
    ap.add_argument("--only", choices=("attn", "weights", "quant", "prefill_quant", "i8",
                                       "block32"),
                    default=None,
                    help="time one group of kernels (default: all)")
    args = ap.parse_args(argv)

    import torch

    from ..ops.cuda import build, flash_decode, flash_prefill, flash_q8, qmm, qmm_i8, qmm_id
    from ..quant.wire import WireTensor
    from ..utils.synthetic import llama3_8b_config, mixtral_8x7b_config, random_experts, \
        random_wire

    if not torch.cuda.is_available():
        print("attn_compare: no CUDA device", file=sys.stderr)
        return 2
    load_baseline(args.baseline.resolve())
    b_build = importlib.import_module(BASE + ".ops.cuda.build")
    b_decode = importlib.import_module(BASE + ".ops.cuda.flash_decode")
    b_prefill = importlib.import_module(BASE + ".ops.cuda.flash_prefill")
    b_q8 = importlib.import_module(BASE + ".ops.cuda.flash_q8")
    b_qmm = importlib.import_module(BASE + ".ops.cuda.qmm")
    b_qmm_id = importlib.import_module(BASE + ".ops.cuda.qmm_id")
    b_qmm_i8 = importlib.import_module(BASE + ".ops.cuda.qmm_i8")
    b_wire = importlib.import_module(BASE + ".quant.wire")
    names = {"attn": ("flash_decode_dense", "flash_prefill"),
             "weights": ("qmv", "qgemm", "qmv_id", "qgemm_id"),
             "quant": ("flash_decode_quant",),
             "prefill_quant": ("flash_prefill_quant", "flash_prefill"),
             "i8": ("qmm_i8",),
             "block32": ("qmv", "qmv_id")}
    names = sum((v for k, v in names.items() if args.only in (None, k)), ())
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        secs = list(pool.map(lambda bld: bld.build(names), (build, b_build)))
    print(f"[compare] built {json.dumps(secs)}", flush=True)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)
    H, Hkv, D = 32, 8, 128
    scale = D**-0.5
    sdpa = torch.nn.functional.scaled_dot_product_attention
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=dev)

    def rnd(*s):
        return torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)

    def host_us(fn, n=200) -> float:
        """Host time of one call, the device's drain excluded."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        dt = time.perf_counter() - t0
        torch.cuda.synchronize()
        return dt / n * 1e6

    def spans(fns) -> list:
        """[(enqueue ms, device ms)] medians of each fn, taken in turns."""
        for fn in fns:
            fn(), fn()
        times = [([], []) for _ in fns]
        for _ in range(args.iters):
            for fn, (enq, devt) in zip(fns, times):
                for hold, t in ((False, enq), (True, devt)):
                    flush.zero_()
                    if hold:
                        torch.cuda._sleep(400_000)
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    fn()
                    b.record()
                    torch.cuda.synchronize()
                    t.append(a.elapsed_time(b))
        return [(statistics.median(e), statistics.median(d)) for e, d in times]

    rows = []

    def compare(shape, callees, plain, tol=TOL_ATTN, library=True):
        """callees: (label, fn) pairs; with `library`, the last is a library
        call (SDPA) and has no error check; with plain None, the caller has
        checked the callees."""
        ref = plain() if plain is not None else None
        for label, fn in (callees[:-1] if library else callees) if ref is not None else ():
            err = rel_err(fn(), ref)
            if err > tol:
                raise RuntimeError(f"attn_compare: {label} at {shape}: error {err:.3e}")
        torch.cuda.synchronize()
        for (label, fn), (enq, devt) in zip(callees, spans([fn for _, fn in callees])):
            host = host_us(fn)
            rows.append({"shape": shape, "callee": label, "enqueue_ms": enq, "device_ms": devt,
                         "host_us": host})
            print(f"[compare] {shape:<34} {label:<22} enqueue {enq:.4f} ms, device "
                  f"{devt:.4f} ms, host {host:.1f} us a call", flush=True)

    if args.only in (None, "weights"):
        weights(args, compare, dev, g, qmm, qmm_id, b_qmm, b_qmm_id, b_wire, WireTensor,
                llama3_8b_config(), mixtral_8x7b_config(), random_wire, random_experts)
    if args.only in (None, "quant"):
        quant(compare, dev, g, flash_q8, b_q8, H, Hkv, D)
    if args.only in (None, "prefill_quant"):
        prefill_quant(compare, dev, g, flash_q8, flash_prefill, b_q8, H, Hkv, D)
    if args.only in (None, "i8"):
        int8(compare, dev, g, qmm_i8, b_qmm_i8, llama3_8b_config(), random_wire)
    if args.only in (None, "block32"):
        block32(compare, dev, g, qmm, qmm_id, b_qmm, b_qmm_id, b_wire, llama3_8b_config(),
                mixtral_8x7b_config(), random_wire, random_experts)
    if args.only in ("weights", "quant", "prefill_quant", "i8", "block32"):
        print(json.dumps({"device": torch.cuda.get_device_name(0), "rows": rows}))
        return 0

    # decode: layer 1 of a 2-layer stacked cache
    q, kc, vc = rnd(1, H, D), rnd(1, Hkv, D), rnd(1, Hkv, D)
    for S, n in ((1024, 1000), (32768, 32765)):
        ks, vs = rnd(2, 1, S, Hkv, D), rnd(2, 1, S, Hkv, D)
        seq = torch.tensor([n], dtype=torch.int32, device=dev)
        kf = torch.cat([ks[1, :, :n], kc[:, None]], 1).transpose(1, 2).contiguous()
        vf = torch.cat([vs[1, :, :n], vc[:, None]], 1).transpose(1, 2).contiguous()
        qf = q[:, :, None]
        compare(f"decode seq_len={n} S={S}", [
            ("K4 this", lambda: flash_q8.flash_decode_stacked_dense(q, ks, vs, 1, kc, vc, seq,
                                                                     scale)),
            ("K4 baseline", lambda: b_q8.flash_decode_stacked_dense(q, ks, vs, 1, kc, vc, seq,
                                                                     scale)),
            ("K9 this", lambda: flash_decode.flash_decode_kernel(q, ks[1], vs[1], kc, vc, seq,
                                                                  scale)),
            ("K9 baseline", lambda: b_decode.flash_decode_kernel(q, ks[1], vs[1], kc, vc, seq,
                                                                  scale)),
            ("sdpa", lambda: sdpa(qf, kf, vf, scale=scale, enable_gqa=True))],
            lambda: flash_q8.flash_decode_stacked_dense_plain(q, ks, vs, 1, kc, vc, seq, scale))
        del ks, vs, kf, vf
        torch.cuda.empty_cache()

    # prefill over a 1024-slot layer
    S = 1024
    kl, vl = rnd(1, S, Hkv, D), rnd(1, S, Hkv, D)
    for T, n in ((128, 0), (128, S - 128), (512, 0)):
        qp, kcp, vcp = rnd(1, T, H, D), rnd(1, T, Hkv, D), rnd(1, T, Hkv, D)
        seq = torch.tensor([n], dtype=torch.int32, device=dev)
        qs = qp.transpose(1, 2)
        kfull = torch.cat([kl[:, :n], kcp], 1).transpose(1, 2).contiguous()
        vfull = torch.cat([vl[:, :n], vcp], 1).transpose(1, 2).contiguous()
        allowed = (torch.arange(n + T, device=dev)[None, :]
                   <= (n + torch.arange(T, device=dev))[:, None])
        compare(f"prefill T={T} seq_len={n} S={S}", [
            ("K5 this", lambda: flash_prefill.flash_prefill_kernel(qp, kl, vl, kcp, vcp, seq,
                                                                    scale)),
            ("K5 baseline", lambda: b_prefill.flash_prefill_kernel(qp, kl, vl, kcp, vcp, seq,
                                                                    scale)),
            ("sdpa", lambda: sdpa(qs, kfull, vfull, attn_mask=allowed, scale=scale,
                                  enable_gqa=True))],
            lambda: flash_prefill.flash_prefill_attention_plain(qp, kl, vl, kcp, vcp, seq,
                                                                scale))
    print(json.dumps({"device": torch.cuda.get_device_name(0), "rows": rows}))
    return 0


def quant(compare, dev, g, flash_q8, b_q8, H, Hkv, D):
    """K6 (flash_decode_stacked) and K8 (flash_decode_q8, the per-layer
    entry) of both trees over the same planes, against the plain version."""
    import torch

    from ..runtime.kv_cache import QuantKVCache

    scale = D**-0.5
    q, kc, vc = (torch.randn(1, h, D, generator=g, device=dev).to(torch.bfloat16)
                 for h in (H, Hkv, Hkv))
    for kind in ("q8_0", "q4_0"):
        kinds = (kind, kind)
        for S, n in ((1024, 1000), (32768, 32765)):
            cache = QuantKVCache.create(2, 1, S, Hkv, D, D, kinds=kinds, device=dev)
            for il in range(2):  # one layer at a time keeps the f32 staging small
                kv = [torch.randn(1, 1, S, Hkv, D, generator=g, device=dev) for _ in "kv"]
                part = QuantKVCache([p[il:il + 1] for p in cache.k_planes],
                                    [p[il:il + 1] for p in cache.v_planes], kinds, Hkv)
                part.write_all(*kv, torch.zeros(1, dtype=torch.int32, device=dev))
            kp, vp = cache.k_planes, cache.v_planes
            kl, vl = [p[1] for p in kp], [p[1] for p in vp]
            seq = torch.tensor([n], dtype=torch.int32, device=dev)
            compare(f"K6 {kind} seq_len={n} S={S}", [
                ("K6 this", lambda: flash_q8.flash_decode_stacked(q, kp, vp, 1, kc, vc, seq, scale,
                                                                  kinds=kinds)),
                ("K6 baseline", lambda: b_q8.flash_decode_stacked(q, kp, vp, 1, kc, vc, seq,
                                                                  scale, kinds=kinds)),
                ("K8 this", lambda: flash_q8.flash_decode_q8(q, kl, vl, kc, vc, seq, scale,
                                                             kinds=kinds)),
                ("K8 baseline", lambda: b_q8.flash_decode_q8(q, kl, vl, kc, vc, seq, scale,
                                                             kinds=kinds))],
                lambda: flash_q8.flash_decode_stacked_plain(q, kp, vp, 1, kc, vc, seq, scale,
                                                            kinds=kinds), library=False)
            del cache, kp, vp, kl, vl, part, kv
            torch.cuda.empty_cache()


def prefill_quant(compare, dev, g, flash_q8, flash_prefill, b_q8, H, Hkv, D):
    """K7 (flash_prefill_q8) of both trees over the same planes, and K5 of
    this tree over the dense cache of the same values, against K7's plain
    version."""
    import torch

    from ..runtime.kv_cache import QuantKVCache, kv_dequant_planes

    scale = D**-0.5
    for kind in ("q8_0", "q4_0"):
        kinds = (kind, kind)
        for S, shapes in ((1024, ((128, 0), (128, 896))), (4096, ((2048, 0), (2048, 2048)))):
            cache = QuantKVCache.create(1, 1, S, Hkv, D, D, kinds=kinds, device=dev)
            kv = [torch.randn(1, 1, S, Hkv, D, generator=g, device=dev) for _ in "kv"]
            cache.write_all(*kv, torch.zeros(1, dtype=torch.int32, device=dev))
            kp, vp = [p[0] for p in cache.k_planes], [p[0] for p in cache.v_planes]
            kd, vd = (kv_dequant_planes(kind, tuple(p.reshape(1, S, Hkv, -1) for p in planes),
                                        torch.float32).to(torch.bfloat16) for planes in (kp, vp))
            for T, n in shapes:
                q, kc, vc = (torch.randn(1, T, h, D, generator=g, device=dev).to(torch.bfloat16)
                             for h in (H, Hkv, Hkv))
                seq = torch.tensor([n], dtype=torch.int32, device=dev)
                compare(f"K7 {kind} T={T} seq_len={n} S={S}", [
                    ("K7 this", lambda: flash_q8.flash_prefill_q8(q, kp, vp, kc, vc, seq, scale,
                                                                  kinds=kinds)),
                    ("K7 baseline", lambda: b_q8.flash_prefill_q8(q, kp, vp, kc, vc, seq, scale,
                                                                  kinds=kinds)),
                    ("K5 dense this", lambda: flash_prefill.flash_prefill_kernel(
                        q, kd, vd, kc, vc, seq, scale))],
                    lambda: flash_q8.flash_prefill_q8_plain(q, kp, vp, kc, vc, seq, scale,
                                                            kinds=kinds), library=False)
            del cache, kv, kp, vp, kd, vd
            torch.cuda.empty_cache()


def weights(args, compare, dev, g, qmm, qmm_id, b_qmm, b_qmm_id, b_wire, WireTensor, cfg, mcfg,
            random_wire, random_experts):
    """qmv, qgemm, qmv_id and qgemm_id of both trees on the same wire blocks
    (the baseline's wrappers take its own WireTensor class)."""
    import torch

    E, F, V = cfg.n_embd, cfg.n_ff, cfg.n_vocab

    def base(w):
        return b_wire.WireTensor(w.kind, w.shape, w.blocks)

    def cat(outs):
        return torch.cat([o.reshape(-1) for o in outs])

    w = {"qk": random_wire("Q4_K", 5120, E, g, dev), "v": random_wire("Q6_K", 1024, E, g, dev),
         "o": random_wire("Q4_K", E, E, g, dev), "gu": random_wire("Q4_K", 2 * F, E, g, dev),
         "d4": random_wire("Q4_K", E, F, g, dev), "d6": random_wire("Q6_K", E, F, g, dev),
         "head": random_wire("Q6_K", V, E, g, dev),
         # a real Mixtral Q4_K_M file's attention weights
         "q4": random_wire("Q4_K", E, E, g, dev), "k8": random_wire("Q8_0", 1024, E, g, dev),
         "v8": random_wire("Q8_0", 1024, E, g, dev), "o5": random_wire("Q5_K", E, E, g, dev)}
    shapes = [("attn_qk+attn_v", ["qk", "v"]), ("attn_output", ["o"]), ("ffn_gate_up", ["gu"]),
              ("ffn_down Q4_K", ["d4"]), ("ffn_down Q6_K", ["d6"]), ("output Q6_K", ["head"]),
              ("attn_k Q8_0", ["k8"]), ("attn_output Q5_K", ["o5"]),
              ("Mixtral attn_q+k+v", ["q4", "k8", "v8"])]
    for kname, B in (("qmv", 1), ("qgemm", 128), ("qgemm", 512)):
        for label, keys in shapes:
            if kname == "qgemm" and label.startswith("output"):
                continue  # the prefill LM head runs on the last position only: qmv
            ws = [w[k] for k in keys]
            x = torch.randn(B, ws[0].shape[1], generator=g, device=dev).to(torch.bfloat16)
            this_fn, base_fn = getattr(qmm, kname), getattr(b_qmm, kname)
            callees = [(f"{kname} this", lambda: cat(this_fn(x, ws)))]
            if all(wt.kind in b_qmm._KIND_ID for wt in ws):  # else the baseline refuses
                bws = [base(wt) for wt in ws]
                callees.append((f"{kname} baseline", lambda: cat(base_fn(x, bws))))
            compare(f"{kname} B={B} {label}", callees,
                    lambda: cat([qmm.qmm_plain(x, wt) for wt in ws]), TOL_QMM, library=False)
    del w
    torch.cuda.empty_cache()

    n_exp, k_used, Fm = mcfg.n_expert, mcfg.n_expert_used, mcfg.n_ff
    gu = random_experts("Q4_K", n_exp, 2 * Fm, E, g, dev)
    d6 = random_experts("Q6_K", n_exp, E, Fm, g, dev)
    bgu, bd6 = base(gu), base(d6)

    def route(tokens):
        logits = torch.randn(tokens, n_exp, generator=g, device=dev)
        return torch.topk(logits, k_used, dim=-1).indices.reshape(-1).to(torch.int32)

    gather(compare, dev, g, qmm_id, b_qmm_id, base, mcfg, random_experts)
    from ..models.llama import moe_sort

    for tokens in (128, 512):
        ids = route(tokens)
        lay = moe_sort(ids, n_exp, qmm_id.RAGGED_TILE)
        b_lay = moe_sort(ids, n_exp, b_qmm_id.RAGGED_TILE)
        for label, wt, bwt in (("ffn_gate_up_exps", gu, bgu), ("ffn_down_exps", d6, bd6)):
            rows_x = torch.randn(ids.shape[0], wt.shape[2], generator=g,
                                 device=dev).to(torch.bfloat16)
            (dest, te, s_pad), (b_dest, b_te, b_s_pad) = lay, b_lay
            xs = torch.zeros(s_pad, wt.shape[2], dtype=torch.bfloat16,
                             device=dev).index_copy_(0, dest, rows_x)
            b_xs = torch.zeros(b_s_pad, wt.shape[2], dtype=torch.bfloat16,
                               device=dev).index_copy_(0, b_dest, rows_x)
            tt, b_tt = qmm_id.RAGGED_TILE, b_qmm_id.RAGGED_TILE
            ref = qmm_id.qmm_ragged_plain(xs, te, wt, tt).index_select(0, dest)
            # both trees' outputs in (token, slot) pair order
            for who, got in (("this", qmm_id.qmm_ragged(xs, te, wt, tt).index_select(0, dest)),
                             ("baseline", b_qmm_id.qmm_ragged(b_xs, b_te, bwt, b_tt)
                              .index_select(0, b_dest))):
                if rel_err(got, ref) > TOL_QMM:
                    raise RuntimeError(f"attn_compare: qgemm_id {who} at {tokens} tokens: "
                                       f"error {rel_err(got, ref):.3e}")
            compare(f"qgemm_id {label} tokens={tokens} s_pad={s_pad}/{b_s_pad}", [
                ("qgemm_id this", lambda: qmm_id.qmm_ragged(xs, te, wt, tt)),
                ("qgemm_id baseline", lambda: b_qmm_id.qmm_ragged(b_xs, b_te, bwt, b_tt))],
                None, library=False)
    del gu, d6, bgu, bd6
    torch.cuda.empty_cache()


# the expert kinds of llama.cpp's presets beside Q4_K_M's (chip_smoke.py's
# EXPERT_PRESET keys)
EXPERT_KINDS = ("Q8_0", "Q5_K", "Q4_0", "Q4_1", "Q5_0", "Q5_1", "Q2_K", "Q3_K", "IQ4_NL",
                "IQ4_XS", "IQ3_XXS", "IQ3_S", "IQ2_S", "IQ2_XXS", "IQ2_XS", "IQ1_S", "IQ1_M",
                "TQ1_0", "TQ2_0")


def gather(compare, dev, g, qmm_id, b_qmm_id, base, mcfg, random_experts):
    """The gather qmv_id (K10) of both trees at the shapes chip_smoke.py's
    phase 3 holds, on the same wire blocks and routing: the Mixtral-8x7B
    stacks at 2, 16 and 32 rows (one token's, 8 tokens' and 16 tokens' top
    2; the offset entry, K12, at 2 rows), every other expert kind there at
    2 and 32, 32 rows all on one expert and 32 on four, and the families'
    stacks at one token's and four tokens' rows (top k of their experts)."""
    import torch

    from ..utils import synthetic

    def routed(n_exp, k_used, tokens):
        logits = torch.randn(tokens, n_exp, generator=g, device=dev)
        return torch.topk(logits, k_used, dim=-1).indices.reshape(-1).to(torch.int32)

    def run(label, w, ids, offset=False):
        bw = base(w)
        x = torch.randn(ids.shape[0], w.shape[2], generator=g, device=dev).to(torch.bfloat16)
        callees = [("qmv_id gather this", lambda: qmm_id.qmm_gather(x, ids, w)),
                   ("qmv_id gather baseline", lambda: b_qmm_id.qmm_gather(x, ids, bw))]
        if offset:
            callees += [("qmv_id offset this", lambda: qmm_id.qmm_gather_offset(x, ids, w)),
                        ("qmv_id offset baseline",
                         lambda: b_qmm_id.qmm_gather_offset(x, ids, bw))]
        compare(f"qmv_id {label} S={ids.shape[0]}", callees,
                lambda: qmm_id.qmm_gather_plain(x, ids, w), TOL_QMM, library=False)

    E, Fm, n_exp, k_used = mcfg.n_embd, mcfg.n_ff, mcfg.n_expert, mcfg.n_expert_used
    for kind in ("Q4_K", "Q6_K", *EXPERT_KINDS):
        for stem, N, K in (("ffn_gate_up_exps", 2 * Fm, E), ("ffn_down_exps", E, Fm)):
            if (kind, stem) in (("Q4_K", "ffn_down_exps"), ("Q6_K", "ffn_gate_up_exps")):
                continue  # a Q4_K_M file's experts: Q4_K gate_up, Q6_K down
            w = random_experts(kind, n_exp, N, K, g, dev)
            label = f"{stem} {kind} {n_exp}x{N}x{K}"
            # a Q4_K_M file's stacks also at 8 tokens' rows (chip_smoke.py's
            # 8-row Mixtral run: grouped)
            for tokens in (1, 8, 16) if kind in ("Q4_K", "Q6_K") else (1, 16):
                run(label, w, routed(n_exp, k_used, tokens),
                    offset=tokens == 1 and stem == "ffn_gate_up_exps" and kind == "Q4_K")
            if kind in ("Q4_K", "Q6_K"):  # skewed routing: 32 rows on one expert, and on four
                run(label + " one expert", w, torch.full((32,), 5, dtype=torch.int32,
                                                         device=dev))
                run(label + " four experts", w,
                    torch.arange(32, device=dev, dtype=torch.int32) % 4 * 2)
            del w
            torch.cuda.empty_cache()
    # the families' stacks: (config, [(kind, N, K)]); a stack's K that 256
    # does not divide is padded (DeepSeek-V2-Lite's downs)
    families = []
    for name in ("qwen3-30b-a3b", "deepseek-v2-lite", "deepseek-v2", "llama4-scout",
                 "olmoe-1b-7b", "granite-3.1-3b-a800m"):
        c = synthetic.CONFIGS[name]()
        f, e = c.n_ff_exp, c.n_embd
        down = {"qwen3-30b-a3b": ("Q6_K",), "deepseek-v2-lite": ("Q5_0", "Q8_0"),
                "deepseek-v2": ("Q4_K",)}.get(name, ("Q6_K",))
        families.append((name, c.n_expert, c.n_expert_used,
                         [("Q4_K", 2 * f, e), *((kd, e, f) for kd in down)]))
    for name, n_x, k_x, stacks in families:
        for kind, N, K in stacks:
            w = random_experts(kind, n_x, N, K, g, dev)
            for tokens in (1, 4):
                run(f"{name} {kind} {n_x}x{N}x{K}", w, routed(n_x, k_x, tokens))
            del w
            torch.cuda.empty_cache()


def block32(compare, dev, g, qmm, qmm_id, b_qmm, b_qmm_id, b_wire, cfg, mcfg, random_wire,
            random_experts):
    """qmv and the gather qmv_id of both trees over the 32-weight-block
    kinds at whole runs (K 4096 and 14336), on the same wire blocks."""
    import torch

    E, F, n_exp, k_used = cfg.n_embd, cfg.n_ff, mcfg.n_expert, mcfg.n_expert_used
    for kind in ("Q4_0", "Q4_1", "Q5_0", "Q5_1", "Q8_0", "IQ4_NL"):
        for label, N, K in (("ffn_gate_up", 2 * F, E), ("ffn_down", E, F)):
            w = random_wire(kind, N, K, g, dev)
            bw = b_wire.WireTensor(w.kind, w.shape, w.blocks)
            x = torch.randn(1, K, generator=g, device=dev).to(torch.bfloat16)
            compare(f"qmv B=1 {label} {kind}", [
                ("qmv this", lambda: qmm.qmv(x, [w])[0]),
                ("qmv baseline", lambda: b_qmm.qmv(x, [bw])[0])],
                lambda: qmm.qmm_plain(x, w), TOL_QMM, library=False)
            del w, bw
        for label, N, K in (("ffn_gate_up_exps", 2 * mcfg.n_ff, E), ("ffn_down_exps", E,
                                                                    mcfg.n_ff)):
            w = random_experts(kind, n_exp, N, K, g, dev)
            bw = b_wire.WireTensor(w.kind, w.shape, w.blocks)
            for tokens in (1, 16):
                ids = torch.topk(torch.randn(tokens, n_exp, generator=g, device=dev), k_used,
                                 dim=-1).indices.reshape(-1).to(torch.int32)
                x = torch.randn(ids.shape[0], K, generator=g, device=dev).to(torch.bfloat16)
                compare(f"qmv_id {label} {kind} S={ids.shape[0]}", [
                    ("qmv_id gather this", lambda: qmm_id.qmm_gather(x, ids, w)),
                    ("qmv_id gather baseline", lambda: b_qmm_id.qmm_gather(x, ids, bw))],
                    lambda: qmm_id.qmm_gather_plain(x, ids, w), TOL_QMM, library=False)
            del w, bw
        torch.cuda.empty_cache()


def int8(compare, dev, g, qmm_i8, b_qmm_i8, cfg, random_wire):
    """K13 of both trees on the same planes and activations, beside
    torch._int_mm (the int32 products alone); the activation quantization
    kernel of this tree beside the baseline's route (torch ops)."""
    import torch

    from ..quant.mmq import build_mmq_planes

    E, F = cfg.n_embd, cfg.n_ff
    for B, K in ((512, E), (512, F)):
        x = torch.randn(B, K, generator=g, device=dev).to(torch.bfloat16)
        ref = qmm_i8.quantize_activations(x)
        if not all(torch.equal(a, b) for a, b in zip(qmm_i8.quantize_kernel(x), ref)):
            raise RuntimeError(f"attn_compare: quantize_i8 at B={B} K={K} is not bit-equal")
        compare(f"quantize B={B} K={K}", [
            ("quantize_i8 this", lambda: qmm_i8.quantize_kernel(x)),
            ("quantize baseline", lambda: b_qmm_i8.quantize_activations(x))], None,
            library=False)
    for label, kind, N, K in (("attn_qk", "Q4_K", 5120, E), ("attn_v", "Q6_K", 1024, E),
                              ("attn_output", "Q4_K", E, E), ("ffn_gate_up", "Q4_K", 2 * F, E),
                              ("ffn_down", "Q4_K", E, F)):
        qi8, ws8T = build_mmq_planes(random_wire(kind, N, K, g, dev))
        for B in (512, 300):
            xq, xs = qmm_i8.quantize_activations(
                torch.randn(B, K, generator=g, device=dev).to(torch.bfloat16))
            compare(f"qmm_i8 {label} B={B}", [
                ("qmm_i8 this", lambda: qmm_i8.qmm_i8_kernel(xq, xs, qi8, ws8T)),
                ("qmm_i8 baseline", lambda: b_qmm_i8.qmm_i8_kernel(xq, xs, qi8, ws8T)),
                ("torch._int_mm", lambda: torch._int_mm(xq, qi8.t()))],
                lambda: qmm_i8.qmm_i8_plain(xq, xs, qi8, ws8T), 1e-6)
        del qi8, ws8T
        torch.cuda.empty_cache()


if __name__ == "__main__":
    raise SystemExit(main())
