"""Instruction counts of the built CUDA kernels, from ``cuobjdump -sass``.

    python -m llamacog_tpu_torch.tools.sass_count [--baseline DIR] [KERNEL ...]

Builds the named kernel libraries (default: qmv qgemm) of this tree and, with
``--baseline``, of another checkout (imported as ``tools/attn_compare.py``
imports it), disassembles each, and prints for every kernel function its
instruction count, its int->float conversions (I2F, I2FP) and, for each
loop (a backward branch and the instructions it jumps over), the loop's
instruction count with its conversions, byte permutes (PRMT), f32 fused
multiply-adds (FFMA), global loads (LDG) and tensor-core MMAs (HMMA). A
loop's count divided by the weights one lane handles in one trip gives the
instructions a weight costs (for example qmv at one activation row: 32
weights a row, times the rows a warp owns). One JSON line at the end holds
all of it.
"""

from __future__ import annotations

import argparse
import collections
import importlib
import json
import re
import subprocess
import sys
from pathlib import Path

from .attn_compare import BASE, load_baseline

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
_FUNC = re.compile(r"Function : (\S+)")
WATCH = ("I2F", "I2FP", "PRMT", "FFMA", "LDG", "HMMA")


def _opcode_family(op: str) -> str:
    return op.split(".")[0]


def parse_sass(text: str) -> dict:
    """{function: [(address, opcode, operands)]} of a cuobjdump -sass listing."""
    funcs, cur = {}, None
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _INSN.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(3), m.group(4)))
    return funcs


def summarize(insns) -> dict:
    fam = collections.Counter(_opcode_family(op) for _, op, _ in insns)
    loops = []
    for i, (addr, op, args) in enumerate(insns):
        if _opcode_family(op) != "BRA":
            continue
        m = re.search(r"0x([0-9a-f]+)", args)
        if not m or int(m.group(1), 16) >= addr:
            continue
        start = int(m.group(1), 16)
        body = [o for a, o, _ in insns if start <= a <= addr]
        c = collections.Counter(_opcode_family(o) for o in body)
        loops.append({"start": hex(start), "end": hex(addr), "insns": len(body),
                      **{w.lower(): c[w] for w in WATCH}})
    return {"insns": len(insns), "i2f": fam["I2F"] + fam["I2FP"],
            "loops": sorted(loops, key=lambda d: -d["insns"])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="llamacog-sass-count")
    ap.add_argument("kernels", nargs="*", default=["qmv", "qgemm"])
    ap.add_argument("--baseline", type=Path, default=None,
                    help="root of another checkout of the repository")
    args = ap.parse_args(argv)

    from ..ops.cuda import build

    trees = [("this", build)]
    if args.baseline is not None:
        load_baseline(args.baseline.resolve())
        trees.append(("baseline", importlib.import_module(BASE + ".ops.cuda.build")))
    cuobjdump = str(Path(build.nvcc()).with_name("cuobjdump"))
    out = {}
    for tree, bld in trees:
        bld.build(tuple(args.kernels))
        for name in args.kernels:
            lib = bld._lib_path(name)
            text = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                                  text=True, check=True, timeout=300).stdout
            for func, insns in parse_sass(text).items():
                s = summarize(insns)
                out[f"{tree} {name} {func}"] = s
                print(f"[sass] {tree} {name} {func}: {s['insns']} instructions, "
                      f"{s['i2f']} int->float", flush=True)
                for lp in s["loops"][:4]:
                    print(f"[sass]    loop {lp['start']}-{lp['end']}: {lp['insns']} "
                          + ", ".join(f"{w} {lp[w.lower()]}" for w in WATCH), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
