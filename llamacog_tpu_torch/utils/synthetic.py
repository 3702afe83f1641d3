"""Synthetic random-weight models built directly in GGUF wire format.

Counterpart of llamacog_tpu/utils/synthetic.py. Benchmarking Llama-3-8B
or Mixtral-8x7B needs full-size weights and no real checkpoint ships with
the repo; decode cost depends on the block bytes only, so the parameters
are random wire blocks made on the device from a torch.Generator.

Each tensor takes the kind llama.cpp's quantizer gives it under a weight
preset (``ftype``): :func:`tensor_kinds` is the port's copy of the llama
family's part of llama_tensor_get_type (the JAX package's
tools/quantize.py::tensor_get_type and use_more_bits) for the presets
Q4_0, Q4_1, Q5_0, Q5_1, Q8_0, Q2_K, Q3_K_S/M/L, Q4_K_S/M, Q5_K_S/M, the
codebook presets IQ4_NL, IQ4_XS, IQ3_XXS, IQ3_XS, IQ3_S, IQ3_M, IQ2_M,
IQ2_S (whose body is the kind IQ2_XS), IQ2_XS, IQ2_XXS, IQ1_M and IQ1_S,
and the ternary TQ1_0 and TQ2_0, with or without an importance matrix
(``imatrix``, the quantizer's QuantizeState.has_imatrix: it moves
IQ3_XXS's ffn_down and, below 4 query heads a kv head, its attn_v;
IQ4_NL/IQ4_XS's first ffn_down layers; and Q4_0/Q5_0's). The public IQ
files are made with an importance matrix, so the card's IQ runs take
``imatrix=True``; the ternary files are not. The weights then arrive fused as
the loader fuses a file of those kinds (q+k+v, else q+k, where the kinds
agree; gate+up; the experts' gate+up per expert). A MoE config
(n_expert > 0) gets an f32 router, as llama.cpp never quantizes
ffn_gate_inp. The default layout, DEFAULT_LAYOUT, is not a preset: it
is Q4_K_M with every dense attn_v Q6_K, the layout of every measurement
made before the other presets ran.
"""

from __future__ import annotations

import torch

from ..models.config import ModelConfig, RopeConfig
from ..quant.wire import BLOCK_BYTES, QK_K, WireTensor

# byte offsets of each kind's f16 scales in QK_K weights (d, and dmin for
# Q4_K, Q5_K and Q2_K; the legacy kinds and IQ4_NL have d, and m for Q4_1
# and Q5_1, at the start of each of their eight 32-weight blocks; the other
# IQ kinds d at byte 0, the ternary ones at the end; IQ1_M's d is spread
# over its scale words: random_wire)
_F16_FIELDS = {"Q4_K": (0, 2), "Q6_K": (208,), "Q8_0": tuple(range(0, 272, 34)),
               "Q5_K": (0, 2), "Q4_0": tuple(range(0, 144, 18)),
               "Q4_1": tuple(o + f for o in range(0, 160, 20) for f in (0, 2)),
               "Q5_0": tuple(range(0, 176, 22)),
               "Q5_1": tuple(o + f for o in range(0, 192, 24) for f in (0, 2)),
               "Q2_K": (80, 82), "Q3_K": (108,), "IQ4_NL": tuple(range(0, 144, 18)),
               "IQ4_XS": (0,), "IQ3_XXS": (0,), "IQ3_S": (0,), "IQ2_S": (0,), "IQ2_XXS": (0,),
               "IQ2_XS": (0,), "IQ1_S": (0,), "IQ1_M": (), "TQ1_0": (52,), "TQ2_0": (64,)}
# preset -> the kind of the tensors no rule moves (llama.cpp's default type)
PRESETS = {"Q4_0": "Q4_0", "Q4_1": "Q4_1", "Q5_0": "Q5_0", "Q5_1": "Q5_1", "Q8_0": "Q8_0",
           "Q2_K": "Q2_K", "Q3_K_S": "Q3_K", "Q3_K_M": "Q3_K", "Q3_K_L": "Q3_K",
           "Q4_K_S": "Q4_K", "Q4_K_M": "Q4_K", "Q5_K_S": "Q5_K", "Q5_K_M": "Q5_K",
           "IQ4_NL": "IQ4_NL", "IQ4_XS": "IQ4_XS", "IQ3_XXS": "IQ3_XXS", "IQ3_XS": "IQ3_S",
           "IQ3_S": "IQ3_S", "IQ3_M": "IQ3_S", "IQ2_M": "IQ2_S", "IQ2_S": "IQ2_XS",
           "IQ2_XS": "IQ2_XS", "IQ2_XXS": "IQ2_XXS", "IQ1_M": "IQ1_M", "IQ1_S": "IQ1_S",
           "TQ1_0": "TQ1_0", "TQ2_0": "TQ2_0"}
# llama.cpp's 1-2 bpw presets, which have rules of their own
LOWBIT_PRESETS = ("IQ2_XXS", "IQ2_XS", "IQ2_S", "IQ2_M", "IQ1_S", "IQ1_M")
# the codebook presets: their public files are made with an importance
# matrix, so the runs on the card (chip_smoke.py, tools/profile.py) take
# imatrix=True for them
CODEBOOK_PRESETS = ("IQ4_NL", "IQ4_XS", "IQ3_XXS", "IQ3_XS", "IQ3_S", "IQ3_M", "IQ2_M", "IQ2_S",
                    "IQ2_XS", "IQ2_XXS", "IQ1_M", "IQ1_S")
# make_synthetic_params' default: Q4_K_M, except that a dense config's attn_v
# is Q6_K in every layer (llama.cpp gives Q6_K only to the "use more bits"
# layers), so attn_q + attn_k fuse and attn_v stays apart in every layer
DEFAULT_LAYOUT = "Q4_K_M, attn_v Q6_K"


def random_wire(kind: str, n: int, k: int, generator: torch.Generator,
                device=None) -> WireTensor:
    """Random [n, k] wire blocks: random bytes for the codes and sub-scales,
    and finite small positive f16 superblock scales in [1e-4, 1e-3] (random
    bits there would give NaN and Inf; IQ1_M's d goes into the top nibbles
    of its four scale words, bytes 49, 51, 53, 55)."""
    bpb = BLOCK_BYTES[kind]
    nb = k // QK_K
    blocks = torch.randint(0, 256, (n, nb, bpb), dtype=torch.uint8,
                           generator=generator, device=device)
    for off in _F16_FIELDS[kind]:
        d = torch.rand((n, nb, 1), generator=generator, device=device) * 9e-4 + 1e-4
        blocks[:, :, off : off + 2] = d.to(torch.float16).view(torch.uint8)
    if kind == "IQ1_M":
        d = torch.rand((n, nb), generator=generator, device=device) * 9e-4 + 1e-4
        d16 = d.to(torch.float16).view(torch.int16).to(torch.int32) & 0xFFFF
        for j in range(4):
            top = ((d16 >> (4 * j)) & 0xF).to(torch.uint8) << 4
            blocks[:, :, 49 + 2 * j] = (blocks[:, :, 49 + 2 * j] & 0x0F) | top
    return WireTensor(kind, (n, k), blocks.reshape(n, nb * bpb))


def _use_more_bits(i: int, n: int) -> bool:
    return i < n // 8 or i >= 7 * n // 8 or (i - n // 8) % 3 == 2


def tensor_kinds(cfg: ModelConfig, ftype: str = "Q4_K_M", imatrix: bool = False) -> dict:
    """The wire kind of every weight of a llama-family GGUF quantized to
    `ftype` (with an importance matrix if `imatrix`): {"token_embd",
    "output", "layers": [{attn_q, attn_k, attn_v, attn_output, ffn_gate,
    ffn_up, ffn_down}]} (the FFN names stand for the stacked experts in a
    MoE config). Unfused, by the GGUF tensor names."""
    if ftype not in PRESETS:
        raise NotImplementedError(
            f"weight preset {ftype} is not ported yet (the port takes {', '.join(PRESETS)})")
    base, n, n_exp = PRESETS[ftype], cfg.n_layer, cfg.n_expert
    n_gqa = cfg.n_head // max(cfg.n_head_kv, 1)
    lowbit = ftype in LOWBIT_PRESETS
    iq2_sm = ftype in ("IQ2_S", "IQ2_M")  # take IQ3_S where the other 1-2 bpw presets Q2_K
    layers = []
    for il in range(n):
        more, first8 = _use_more_bits(il, n), il < n // 8
        if lowbit:
            v = "Q4_K" if n_gqa >= 4 or n_exp >= 4 else "IQ3_S" if iq2_sm else "Q2_K"
            q, k = base, "Q4_K" if n_exp == 8 else base
            down = ("IQ3_S" if iq2_sm else "Q2_K") if first8 else base
            out = ("Q5_K" if n_exp == 8 else "IQ2_XXS" if ftype in ("IQ1_S", "IQ1_M")
                   else "IQ3_S" if iq2_sm else base)
        else:
            v = {"Q2_K": "Q4_K" if n_gqa >= 4 else "Q3_K",
                 "Q3_K_M": "Q5_K" if il < 2 else "Q4_K", "Q3_K_L": "Q5_K",
                 "Q4_K_M": "Q6_K" if more else base, "Q5_K_M": "Q6_K" if more else base,
                 "Q4_K_S": "Q5_K" if il < 4 else base,
                 "IQ3_XXS": "Q4_K" if n_gqa >= 4 else "IQ3_XXS" if imatrix else "IQ3_S",
                 "IQ3_XS": "Q4_K" if n_gqa >= 4 else base, "IQ3_S": "Q4_K" if n_gqa >= 4 else base,
                 "IQ3_M": "Q4_K", "IQ4_NL": "Q5_K" if n_gqa >= 4 else base,
                 "IQ4_XS": "Q5_K" if n_gqa >= 4 else base}.get(ftype, base)
            q = {"IQ3_XS": "IQ3_XXS", "IQ3_XXS": "IQ2_S"}.get(ftype, base)
            k = "Q8_0" if n_exp == 8 else q
            v = "Q8_0" if n_exp == 8 else v
            down = {"Q2_K": "Q3_K", "Q3_K_M": "Q5_K" if il < n // 16 else "Q4_K",
                    "Q3_K_L": "Q5_K", "Q4_K_M": "Q6_K" if more else base,
                    "Q5_K_M": "Q6_K" if more else base, "Q4_K_S": "Q5_K" if first8 else base,
                    "Q4_0": "Q4_1" if imatrix and first8 else base,
                    "Q5_0": "Q5_1" if imatrix and first8 else base,
                    "IQ3_XXS": base if imatrix else "Q4_K" if first8 else "Q3_K",
                    "IQ3_M": "Q4_K" if first8 or (n_exp == 8 and more) else base,
                    "IQ4_NL": "Q5_K" if first8 and not imatrix else base,
                    "IQ4_XS": "Q5_K" if first8 and not imatrix else base}.get(ftype, base)
            if n_exp == 8:
                out = "Q5_K" if ftype in ("Q2_K", "Q3_K_S", "Q3_K_M", "Q4_K_S", "Q4_K_M", "IQ4_NL",
                                          "IQ4_XS", "IQ3_XS", "IQ3_XXS", "IQ3_S", "IQ3_M") else base
            else:
                out = {"Q2_K": "Q3_K", "Q3_K_M": "Q4_K", "Q3_K_L": "Q5_K", "IQ3_XXS": "IQ3_S",
                       "IQ3_M": "Q4_K"}.get(ftype, base)
        layers.append({"attn_q": q, "attn_k": k, "attn_v": v, "attn_output": out,
                       "ffn_gate": base, "ffn_up": base, "ffn_down": down})
    embd = ("IQ3_S" if iq2_sm or ftype == "IQ3_XXS" else "Q2_K" if lowbit
            else "Q4_K" if ftype in ("TQ1_0", "TQ2_0") else base)
    return {"token_embd": embd,
            "output": "Q5_K" if lowbit or ftype == "IQ3_XXS" else "Q8_0" if base == "Q8_0"
            else "Q6_K", "layers": layers}


def layout_kinds(cfg: ModelConfig, layout: str = DEFAULT_LAYOUT, imatrix: bool = False) -> dict:
    """tensor_kinds of a preset, or of DEFAULT_LAYOUT."""
    if layout != DEFAULT_LAYOUT:
        return tensor_kinds(cfg, layout, imatrix)
    kinds = tensor_kinds(cfg, "Q4_K_M")
    if not cfg.n_expert:
        for lk in kinds["layers"]:
            lk["attn_v"] = "Q6_K"
    return kinds


def llama3_8b_config(n_layer: int = 32) -> ModelConfig:
    """Llama-3-8B geometry; `n_layer` cuts depth only."""
    return ModelConfig(
        arch="llama", n_vocab=128256, n_ctx_train=8192, n_embd=4096,
        n_layer=n_layer, n_head=32, n_head_kv=8, n_ff=14336,
        head_dim_k=128, head_dim_v=128,
        rope=RopeConfig(dim=128, freq_base=500000.0),
    )


def llama3_70b_config(n_layer: int = 80) -> ModelConfig:
    """Llama-3-70B geometry (64 query heads over 8 kv heads); `n_layer` cuts
    depth only."""
    return ModelConfig(
        arch="llama", n_vocab=128256, n_ctx_train=8192, n_embd=8192,
        n_layer=n_layer, n_head=64, n_head_kv=8, n_ff=28672,
        head_dim_k=128, head_dim_v=128,
        rope=RopeConfig(dim=128, freq_base=500000.0),
    )


def mixtral_8x7b_config(n_layer: int = 32) -> ModelConfig:
    """Mixtral-8x7B geometry (8 experts, top-2, normalized softmax gating);
    `n_layer` cuts depth only."""
    return ModelConfig(
        arch="llama", n_vocab=32000, n_ctx_train=8192, n_embd=4096,
        n_layer=n_layer, n_head=32, n_head_kv=8, n_ff=14336,
        head_dim_k=128, head_dim_v=128, n_expert=8, n_expert_used=2,
        expert_weights_norm=True, rope=RopeConfig(dim=128, freq_base=1e6),
    )


def random_experts(kind: str, n_exp: int, n: int, k: int, generator: torch.Generator,
                   device=None) -> WireTensor:
    """A random stack of n_exp [n, k] experts, [n_exp, n, k]."""
    w = random_wire(kind, n_exp * n, k, generator, device)
    return WireTensor(kind, (n_exp, n, k), w.blocks)


def make_synthetic_params(cfg: ModelConfig, seed: int = 0, device=None,
                          ftype: str = DEFAULT_LAYOUT, imatrix: bool = False) -> dict:
    """Random params of a GGUF quantized to the preset `ftype` (with an
    importance matrix if `imatrix`), or laid out as DEFAULT_LAYOUT
    (layout_kinds), for the llama forward, on `device`, fused as the loader
    fuses such a file."""
    from .. import resolve_device

    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    kinds = layout_kinds(cfg, ftype, imatrix)
    E, F = cfg.n_embd, cfg.n_ff
    kv = cfg.n_head_kv * cfg.head_dim_k
    params: dict = {
        "tok_embd": random_wire(kinds["token_embd"], cfg.n_vocab, E, g, dev),
        "output": random_wire(kinds["output"], cfg.n_vocab, E, g, dev),
        "output_norm": torch.ones(E, dtype=torch.float32, device=dev),
        "layers": [],
    }
    for lk in kinds["layers"]:
        layer = {
            "attn_norm": torch.ones(E, dtype=torch.float32, device=dev),
            "ffn_norm": torch.ones(E, dtype=torch.float32, device=dev),
        }
        rows = {"attn_q": cfg.n_head * cfg.head_dim_k, "attn_k": kv,
                "attn_v": cfg.n_head_kv * cfg.head_dim_v}
        if lk["attn_q"] == lk["attn_k"] == lk["attn_v"]:
            layer["attn_qkv"] = random_wire(lk["attn_q"], sum(rows.values()), E, g, dev)
        elif lk["attn_q"] == lk["attn_k"]:
            layer["attn_qk"] = random_wire(lk["attn_q"], rows["attn_q"] + kv, E, g, dev)
            layer["attn_v"] = random_wire(lk["attn_v"], rows["attn_v"], E, g, dev)
        else:
            for key, n in rows.items():
                layer[key] = random_wire(lk[key], n, E, g, dev)
        layer["attn_output"] = random_wire(lk["attn_output"], E, cfg.n_head * cfg.head_dim_v,
                                           g, dev)
        if cfg.n_expert > 0:
            n_exp = cfg.n_expert
            layer["ffn_gate_inp"] = torch.randn((n_exp, E), generator=g, device=dev) * 0.02
            layer["ffn_gate_up_exps"] = random_experts(lk["ffn_gate"], n_exp, 2 * F, E, g, dev)
            layer["ffn_down_exps"] = random_experts(lk["ffn_down"], n_exp, E, F, g, dev)
        else:
            layer["ffn_gate_up"] = random_wire(lk["ffn_gate"], 2 * F, E, g, dev)
            layer["ffn_down"] = random_wire(lk["ffn_down"], E, F, g, dev)
        params["layers"].append(layer)
    return params


def synthetic_vocab(n_vocab: int = 128256):
    """An SPM vocab of Llama-3's size and special ids for a synthetic model
    served without a tokenizer file (requests send token ids): ids 0-255 are
    the byte tokens <0x00>..<0xFF>, 256-127999 the plain tokens "<tN>" (no
    piece is part of another, so a piece makes an unambiguous stop string),
    128000 <|begin_of_text|> (BOS), 128001 <|end_of_text|> (EOS), 128009
    <|eot_id|> (EOT: end of generation with EOS) and the rest reserved
    control tokens, as in Llama-3's vocab. The JSON grammars match the byte
    tokens only."""
    from ..tokenizer import Vocab

    names = {128000: "<|begin_of_text|>", 128001: "<|end_of_text|>", 128009: "<|eot_id|>"}
    tokens = [f"<0x{i:02X}>" for i in range(256)]
    tokens += [f"<t{i}>" for i in range(256, 128000)]
    tokens += [names.get(i, f"<|reserved_special_token_{i - 128000}|>")
               for i in range(128000, n_vocab)]
    types = [6] * 256 + [1] * (128000 - 256) + [3] * (n_vocab - 128000)
    return Vocab.from_metadata({
        "tokenizer.ggml.model": "llama", "tokenizer.ggml.tokens": tokens,
        "tokenizer.ggml.token_type": types, "tokenizer.ggml.bos_token_id": 128000,
        "tokenizer.ggml.eos_token_id": 128001, "tokenizer.ggml.eot_token_id": 128009})
