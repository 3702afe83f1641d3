"""The tile height of qgemm (K2/K3) against both fixed heights, on one GPU.

    python -m llamacog_tpu_torch.tools.qgemm_tiles [--iters 21] [--rows 96,128,...]

``lcg_qgemm`` picks 64-row or 128-row tiles from the batch, the weight
blocks and the card's SM count (csrc/qgemm.cu, ``rows64``). This builds two
copies of csrc/qgemm.cu with that choice fixed — 64 rows always, 128 rows
always — into ``csrc/build/qgemm_tiles/``, and times them and the shipped
kernel in turns (CUDA events, L2 flushed, the card held busy past the
host's enqueue: the device's time alone; median) on the five Llama-3-8B
layer weights (attn_qk + attn_v in one launch) at each batch of ``--rows``.
Each output is held against ``qmm_plain`` within the qgemm tolerance. Prints
one line per shape with the three times and the height the rule took, and
a JSON line of all of them.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

TOL_QMM = 1e-4  # chip_smoke.py
RULE = "const bool rows64 ="


def build_fixed(build, rows: int):
    """csrc/qgemm.cu with the tile height fixed at `rows`, built and bound."""
    out = build.BUILD_DIR / "qgemm_tiles" / str(rows)
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    for src in build.CSRC.glob("*.cuh"):
        shutil.copy(src, out / src.name)
    text = (build.CSRC / "qgemm.cu").read_text()
    lines = [ln for ln in text.splitlines() if RULE in ln]
    if len(lines) != 1:
        raise RuntimeError(f"qgemm_tiles: csrc/qgemm.cu has {len(lines)} lines with {RULE!r}")
    indent = lines[0][:len(lines[0]) - len(lines[0].lstrip())]
    fixed = f"{indent}{RULE} {'true' if rows == 64 else 'false'};"
    (out / "qgemm.cu").write_text(text.replace(lines[0], fixed))
    lib = out / "qgemm.so"
    r = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(out / "qgemm.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"qgemm_tiles: nvcc failed for {rows} rows:\n{r.stdout}{r.stderr}")
    handle = ctypes.CDLL(str(lib))
    build._bind(handle)
    return handle


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="llamacog-qgemm-tiles")
    ap.add_argument("--iters", type=int, default=21)
    ap.add_argument("--rows", default="96,128,192,256,384,512",
                    help="comma-separated batches (rows of x)")
    args = ap.parse_args(argv)

    import torch

    from ..ops.cuda import build, qmm
    from ..utils.synthetic import llama3_8b_config, random_wire

    if not torch.cuda.is_available():
        print("qgemm_tiles: no CUDA device", file=sys.stderr)
        return 2
    with ThreadPoolExecutor(3) as pool:
        shipped = pool.submit(build.load, "qgemm")
        fixed = {r: pool.submit(build_fixed, build, r) for r in (64, 128)}
        libs = {"shipped": shipped.result(), **{f"{r} rows": f.result() for r, f in fixed.items()}}
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cfg = llama3_8b_config()
    E, F = cfg.n_embd, cfg.n_ff
    g = torch.Generator(device=dev).manual_seed(1234)
    w = {"qk": random_wire("Q4_K", 5120, E, g, dev), "v": random_wire("Q6_K", 1024, E, g, dev),
         "o": random_wire("Q4_K", E, E, g, dev), "gu": random_wire("Q4_K", 2 * F, E, g, dev),
         "d4": random_wire("Q4_K", E, F, g, dev), "d6": random_wire("Q6_K", E, F, g, dev)}
    shapes = [("attn_qk+attn_v", ["qk", "v"]), ("attn_output", ["o"]), ("ffn_gate_up", ["gu"]),
              ("ffn_down Q4_K", ["d4"]), ("ffn_down Q6_K", ["d6"])]
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=dev)

    def call(lib, x, ws):
        n = len(ws)
        outs = [torch.empty((x.shape[0], t.shape[0]), device=dev) for t in ws]
        rc = lib.lcg_qgemm(
            x.data_ptr(), build.DTYPE_ID[x.dtype], x.shape[0], x.shape[1], n,
            (ctypes.c_void_p * n)(*[t.blocks.data_ptr() for t in ws]),
            (ctypes.c_void_p * n)(*[o.data_ptr() for o in outs]),
            (ctypes.c_int * n)(*[qmm._KIND_ID[t.kind] for t in ws]),
            (ctypes.c_int * n)(*[t.shape[0] for t in ws]), torch.cuda.current_stream().cuda_stream)
        build.check(lib, rc, "qgemm_tiles")
        return outs

    rows = []
    print(f"[tiles] {torch.cuda.get_device_name(dev)}, {sms} SMs", flush=True)
    for B in (int(b) for b in args.rows.split(",")):
        for label, keys in shapes:
            ws = [w[k] for k in keys]
            x = torch.randn(B, ws[0].shape[1], generator=g, device=dev).to(torch.bfloat16)
            ref = torch.cat([qmm.qmm_plain(x, t).reshape(-1) for t in ws])
            for name, lib in libs.items():
                got = torch.cat([o.reshape(-1) for o in call(lib, x, ws)])
                err = float((got - ref).abs().max() / ref.abs().max())
                if err > TOL_QMM:
                    raise RuntimeError(f"qgemm_tiles: {name} at {label} B={B}: error {err:.3e}")
            times = {name: [] for name in libs}
            for it in range(args.iters + 1):
                for name, lib in libs.items():
                    flush.zero_()
                    torch.cuda._sleep(400_000)
                    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    a.record()
                    call(lib, x, ws)
                    b.record()
                    torch.cuda.synchronize()
                    if it:  # the first turn warms up
                        times[name].append(a.elapsed_time(b))
            ms = {name: statistics.median(t) for name, t in times.items()}
            blocks = sum((t.shape[0] + 127) // 128 for t in ws)
            took = 64 if B <= 64 or -(-B // 64) * blocks <= sms else 128
            rows.append({"shape": label, "B": B, "blocks_64": -(-B // 64) * blocks,
                         "rule_rows": took, **{f"{k} ms": v for k, v in ms.items()}})
            print(f"[tiles] {label:<15} B={B:<4} {-(-B // 64) * blocks:>4} blocks of 64 rows: "
                  f"64 rows {ms['64 rows']:.4f} ms, 128 rows {ms['128 rows']:.4f} ms, shipped "
                  f"{ms['shipped']:.4f} ms (takes {took})", flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(dev), "sms": sms, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
