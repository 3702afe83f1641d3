"""K10's two kernels side by side, at the routing a model's router gives.

    python -m llamacog_tpu_torch.tools.gather_rule [--iters 21] [--only rule|ring]
        [--variant DIR ...]

qmv_id (csrc/qmv_id.cu) either takes a block per row (``qid_rows_kernel``)
or groups its rows by expert (``qid_group_kernel``), and
``ops/cuda/qmm_id.py::gather_groups`` picks one from the shapes alone. This
times both kernels of this tree on the same inputs, one call of each in
turn, L2 flushed before each call, the card held busy ~0.2 ms past the flush
so the span is the device's alone (as ``tools/attn_compare.py``'s device
span):

- ``--only rule``: S rows of `tokens` tokens' top k of random router
  logits (distinct experts a token, balanced on average), for every token
  count whose rows the grouping kernel takes (2 to 32 rows), over the
  Mixtral-8x7B stacks (Q4_K gate_up, Q6_K down) and each MoE family's
  (Qwen3-30B-A3B, OLMoE-1B-7B, Granite-3.1-3B-A800M, DeepSeek-V2-Lite,
  DeepSeek-V2, Llama-4-Scout), two routings each. Each line gives the rows'
  distinct experts and the rule's choice beside the faster kernel;
- ``--only ring``: the grouping kernel over the Mixtral stacks of every
  expert kind at 16 and 32 rows (random top 2) and at 32 rows on one
  expert. With ``--variant DIR`` (another checkout, for example a copy
  whose ``qid_ring`` sends every kind, or none, through the shared-memory
  ring) the grouping kernel of each variant is timed in the same turns.

Every output is held against ``qmm_gather_plain`` at 1e-4 relative to the
largest |reference|. Prints a line per shape and a JSON line of all rows.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import statistics
import sys
from pathlib import Path

from .attn_compare import EXPERT_KINDS, TOL_QMM, load_baseline, rel_err

FAMILIES = ("qwen3-30b-a3b", "olmoe-1b-7b", "granite-3.1-3b-a800m", "deepseek-v2-lite",
            "deepseek-v2", "llama4-scout")
GROUP_MAX = 32  # rows the grouping kernel takes (csrc/qmv_id.cu, QID_GROUP_MAX)
TOKENS = (1, 2, 3, 4, 5, 6, 8, 10, 12, 16, 24, 32)  # token counts timed, up to 32 rows
# the down stacks of the families' Q4_K_M files (DeepSeek-V2-Lite's n_ff_exp,
# 1408, takes a 32-weight-block kind)
DOWN_KIND = {"deepseek-v2-lite": "Q8_0", "deepseek-v2": "Q4_K"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="llamacog-gather-rule")
    ap.add_argument("--iters", type=int, default=21)
    ap.add_argument("--only", choices=("rule", "ring"), default=None)
    ap.add_argument("--variant", type=Path, action="append", default=[],
                    help="root of another checkout whose grouping kernel is timed too")
    args = ap.parse_args(argv)

    import importlib

    import torch

    from ..ops.cuda import build, qmm_id
    from ..ops.cuda.qmm import _KIND_ID
    from ..utils import synthetic

    if not torch.cuda.is_available():
        print("gather_rule: no CUDA device", file=sys.stderr)
        return 2
    builds = {"this": build}
    for j, root in enumerate(args.variant):
        name = f"variant{j}_llamacog_tpu_torch"
        load_baseline(root.resolve(), name)
        builds[f"variant{j}"] = importlib.import_module(name + ".ops.cuda.build")
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:  # one nvcc each
        secs = list(pool.map(lambda b: b.build(("qmv_id",)), builds.values()))
    print(f"[rule] built {json.dumps(secs)}", flush=True)
    libs = {v: b.load("qmv_id") for v, b in builds.items()}
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows = []

    def launch(lib, x, ids, w, group):
        n_exp, n, k = w.shape
        out = torch.empty((x.shape[0], n), dtype=torch.float32, device=dev)
        rc = lib.lcg_qmv_id(x.data_ptr(), build.DTYPE_ID[x.dtype], x.shape[0], k,
                            w.blocks.data_ptr(), _KIND_ID[w.kind], n_exp, n, ids.data_ptr(),
                            out.data_ptr(), int(group), stream)
        build.check(lib, rc, "qmv_id")
        return out

    def device_ms(fns):
        for fn in fns:
            fn()
        times = [[] for _ in fns]
        for _ in range(args.iters):
            for fn, t in zip(fns, times):
                flush.zero_()
                torch.cuda._sleep(400_000)
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                fn()
                b.record()
                torch.cuda.synchronize()
                t.append(a.elapsed_time(b))
        return [statistics.median(t) for t in times]

    def time_shape(label, w, ids, callees):
        """callees: (name, lib, group) triples, timed in turns."""
        x = torch.randn(ids.shape[0], w.shape[2], generator=g, device=dev).to(torch.bfloat16)
        ref = qmm_id.qmm_gather_plain(x, ids, w)
        fns = []
        for name, lib, group in callees:
            err = rel_err(launch(lib, x, ids, w, group), ref)
            if err > TOL_QMM:
                raise RuntimeError(f"gather_rule: {name} at {label}: error {err:.3e}")
            fns.append(lambda lib=lib, group=group: launch(lib, x, ids, w, group))
        ms = device_ms(fns)
        used = len(set(ids.tolist()))
        row = {"shape": label, "S": ids.shape[0], "experts_used": used,
               "rule_groups": qmm_id.gather_groups(ids.shape[0], w.shape[0]),
               **{name: t for (name, _, _), t in zip(callees, ms)}}
        rows.append(row)
        print(f"[rule] {label:<52} S={ids.shape[0]:<3} {used:>3} experts used; "
              + ", ".join(f"{name} {t:.4f}" for (name, _, _), t in zip(callees, ms))
              + f" ms; the rule {'groups' if row['rule_groups'] else 'takes a block a row'}",
              flush=True)

    def routed(n_exp, k_used, tokens):
        logits = torch.randn(tokens, n_exp, generator=g, device=dev)
        return torch.topk(logits, k_used, dim=-1).indices.reshape(-1).to(torch.int32)

    mcfg = synthetic.mixtral_8x7b_config()
    E, Fm, n_exp, k_used = mcfg.n_embd, mcfg.n_ff, mcfg.n_expert, mcfg.n_expert_used
    both = [("rows", libs["this"], False), ("group", libs["this"], True)]
    if args.only in (None, "rule"):
        stacks = [("mixtral", n_exp, k_used, "Q4_K", 2 * Fm, E),
                  ("mixtral", n_exp, k_used, "Q6_K", E, Fm)]
        for name in FAMILIES:
            c = synthetic.CONFIGS[name]()
            down = DOWN_KIND.get(name, "Q6_K")
            stacks += [(name, c.n_expert, c.n_expert_used, "Q4_K", 2 * c.n_ff_exp, c.n_embd),
                       (name, c.n_expert, c.n_expert_used, down, c.n_embd, c.n_ff_exp)]
        for name, n_x, k_x, kind, N, K in stacks:
            w = synthetic.random_experts(kind, n_x, N, K, g, dev)
            for tokens in TOKENS:
                if not 2 <= tokens * k_x <= GROUP_MAX:
                    continue
                for _ in range(2):
                    time_shape(f"{name} {kind} {n_x}x{N}x{K}", w, routed(n_x, k_x, tokens),
                               both)
            del w
            torch.cuda.empty_cache()
    if args.only in (None, "ring"):
        ring = [("group", libs["this"], True),
                *((f"{v} group", lib, True) for v, lib in libs.items() if v != "this")]
        for kind in ("Q4_K", "Q6_K", *EXPERT_KINDS):
            for N, K in ((2 * Fm, E), (E, Fm)):
                w = synthetic.random_experts(kind, n_exp, N, K, g, dev)
                label = f"mixtral {kind} {n_exp}x{N}x{K}"
                for tokens in (8, 16):
                    time_shape(label, w, routed(n_exp, k_used, tokens), ring)
                time_shape(label + " one expert", w,
                           torch.full((32,), 5, dtype=torch.int32, device=dev), ring)
                del w
                torch.cuda.empty_cache()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
