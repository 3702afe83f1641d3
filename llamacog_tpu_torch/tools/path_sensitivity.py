"""How far the plain path of a synthetic model moves under small noise.

    python -m llamacog_tpu_torch.tools.path_sensitivity --ftype IQ3_XXS \
        [--model mixtral-8x7b] [--layers 2] [--eps 1e-3] [--only dense|experts]

chip_smoke.py's phase 4 holds the kernel path against the plain path at full
width and 2 layers: prefill logits, 4 teacher-forced decode steps and a
9-token second chunk, bf16, each step within TOL_PATH of the largest
|logit|. The two paths differ by f32 summation orders and the bf16 roundings
those flip. This tool measures how much a model amplifies such differences,
on the CPU and without the card: it runs phase 4's steps on the plain path
twice, the second time with every weight product's output multiplied by
(1 + eps * N(0, 1)) (the dense products, the expert products, or both), and
prints the largest |logit| difference of each step over the largest |logit|,
as phase 4 reads it. A model whose plain path moves past TOL_PATH under
noise of about a bf16 rounding (eps 1e-3) cannot tell a kernel defect from
its own sensitivity at that tolerance. The weights are phase 4's (seed 7;
a codebook preset with an importance matrix's rules). Runs on the CPU only.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="llamacog-path-sensitivity")
    ap.add_argument("--model", choices=("llama3-8b", "mixtral-8x7b"), default="mixtral-8x7b")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--ftype", default=None, help="weight preset (utils/synthetic.py PRESETS)")
    ap.add_argument("--eps", type=float, default=1e-3)
    ap.add_argument("--only", choices=("dense", "experts"), default=None,
                    help="perturb only the dense or only the expert products")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    args = ap.parse_args(argv)

    import torch

    from ..ops import linear
    from ..ops.cuda import qmm, qmm_id
    from ..runtime.engine import Engine
    from ..utils.synthetic import (CODEBOOK_PRESETS, DEFAULT_LAYOUT, llama3_8b_config,
                                   make_synthetic_params, mixtral_8x7b_config)

    moe = args.model == "mixtral-8x7b"
    cfg = (mixtral_8x7b_config if moe else llama3_8b_config)(n_layer=args.layers)
    params = make_synthetic_params(cfg, seed=7, device="cpu", ftype=args.ftype or DEFAULT_LAYOUT,
                                   imatrix=args.ftype in CODEBOOK_PRESETS)
    # phase 4's prompt, teacher-forced tokens and cache size
    prompt = [(i * 7919) % cfg.n_vocab for i in range(2, 22)]
    forced = [11, 12345, 777, 31000 if moe else 90000]
    max_seq = 33 if moe else 1024
    dtype = getattr(torch, args.dtype)

    def steps(eps_dense: float, eps_experts: float) -> list:
        g = torch.Generator().manual_seed(1)
        plain, plain_id = qmm.qmm_plain, qmm_id._plain

        def noisy(t, eps):
            return t * (1 + eps * torch.randn(t.shape, generator=g)) if eps else t

        qmm.qmm_plain = linear.qmm_plain = lambda x, w: noisy(plain(x, w), eps_dense)
        qmm_id._plain = lambda *a: noisy(plain_id(*a), eps_experts)
        try:
            eng = Engine(params, cfg, batch_size=1, max_seq=max_seq, dtype=dtype, device="cpu")
            out = [torch.as_tensor(eng.prefill(prompt))]
            out += [torch.as_tensor(eng.decode_one([t])[0]) for t in forced]
            out.append(torch.as_tensor(eng.prefill(prompt[:9])))
            return out
        finally:
            qmm.qmm_plain = linear.qmm_plain = plain
            qmm_id._plain = plain_id

    ref = steps(0.0, 0.0)
    got = steps(0.0 if args.only == "experts" else args.eps,
                0.0 if args.only == "dense" else args.eps)
    errs = [float((a.double() - b.double()).abs().max() / b.double().abs().max())
            for a, b in zip(got, ref)]
    names = ["prefill", *(f"decode step {i + 1}" for i in range(len(forced))), "prefill chunk 2"]
    print(json.dumps({"model": args.model, "layers": args.layers, "ftype": args.ftype,
                      "dtype": args.dtype, "eps": args.eps,
                      "perturbed": args.only or "all",
                      "max_abs_logit": float(ref[0].abs().max()),
                      "rel_err": dict(zip(names, errs))}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
