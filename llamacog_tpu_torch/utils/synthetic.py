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

A row whose length a 256-weight run does not divide (Qwen2.5-0.5B's n_embd
of 896) takes llama.cpp's 32-weight-block fallback kind
(llama-quant.cpp's convert_incompatible_tensor: Q5_0 for Q4_K, Q5_1 for
Q5_K, Q8_0 for Q6_K, IQ4_NL for the other K-quants and codebook kinds,
Q4_0 for the ternary ones; the LM head and a tied embedding Q8_0), and a
row that 32 does not divide either stays F16 (Jais-13B's ffn_down: a dense
weight), so a synthetic model of such widths has the kinds a real file
has. The config functions give the published geometry of Llama-3, Mixtral,
Qwen2.5, Qwen3, Qwen2-MoE, Qwen3-MoE, Gemma-2 and Gemma-3 members, of the
layer-norm families' (Phi-2, Falcon-7B and -40B, GPT-2, StableLM-2,
StarCoder2, StarCoderBase, Pythia, GPT-J) and of the later families'
(Llama 4, OLMo, Granite, MiniCPM; BLOOM, MPT, Jais, Refact, the llama-graph
clones, Minitron, AFM; the MoE variants DeepSeek-MoE-16B, dots.llm1,
Ling-lite, Phi-3.5-MoE, Grok-1, DBRX and Snowflake Arctic; the last
decoders MiniCPM3-4B, PLM-1.8B, GLM-4-9B-0414, glm-4-9b-chat, Chameleon-7B
and -30B, BitNet b1.58-large, OpenELM-3B and a stated deci pattern at
Nemotron-51B's widths) (CONFIGS by name); make_synthetic_params adds
what each family's file carries beside the weights: q/k/v biases (qwen2,
qwen2moe, stablelm, starcoder2), the other products' biases (_BIASES), norm
biases (the layer-norm families), BLOOM's embedding norm, learned positions
(gpt2, starcoder),
falcon-40B's attn_norm_2, per-head q/k norms (qwen3, qwen3moe, gemma3),
post-attention and post-FFN norms (gemma2, gemma3, grok), the shared expert
and its gate (qwen2moe; ungated in deepseek2, deepseek, dots1, bailingmoe
and llama4), dots1's selection bias, phimoe's biases and rope factor tables,
arctic's dense FFN and MoE-branch norm beside its experts, chameleon's
per-head layer norms with biases, bitnet's sub-norms and one-element
scales (its products unfused), each layer's own head counts and FFN width
(openelm, deci; deci's attention-free, linear-attention and FFN-free
layers), and no output tensor where the embedding is tied (Gemma,
Qwen2.5-0.5B, GPT-2, StarCoderBase, Grok-1, PLM, BitNet, OpenELM).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..models.config import ModelConfig, RopeConfig, _apply_arch_defaults
from ..quant.wire import BLOCK32_KINDS, BLOCK_BYTES, QK_K, WireTensor

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
    of its four scale words, bytes 49, 51, 53, 55). A 32-weight-block kind
    at a k that 256 does not divide gets the zero blocks of its padded rows
    (quant/wire.py)."""
    bpb = BLOCK_BYTES[kind]
    nb = -(-k // QK_K)
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
    blocks = blocks.reshape(n, nb * bpb)
    if k % QK_K:
        blocks[:, k // 32 * (bpb // 8):] = 0
    return WireTensor(kind, (n, k), blocks)


# llama.cpp's kind for a row that 256 does not divide (llama-quant.cpp,
# convert_incompatible_tensor)
_FALLBACK = {"Q4_K": "Q5_0", "Q5_K": "Q5_1", "Q6_K": "Q8_0", "TQ1_0": "Q4_0", "TQ2_0": "Q4_0",
             **{k: "IQ4_NL" for k in ("Q2_K", "Q3_K", "IQ4_XS", "IQ3_XXS", "IQ3_S", "IQ2_S",
                                      "IQ2_XXS", "IQ2_XS", "IQ1_S", "IQ1_M")}}


def fit_kind(kind: str, k: int) -> str:
    """`kind`, or its 32-weight-block fallback for rows of k weights that a
    256-weight run does not divide, or F16 where 32 does not divide them
    either (llama.cpp leaves such a tensor F16: Jais-13B's ffn_down at K
    13653), a dense weight (random_weight)."""
    if k % 32:
        return "F16"
    if k % QK_K == 0 or kind in BLOCK32_KINDS:
        return kind
    return _FALLBACK[kind]


def random_weight(kind: str, n: int, k: int, generator: torch.Generator, device=None):
    """random_wire, or for F16 (fit_kind) a dense [n, k] bf16 weight of
    small draws, as the loader keeps a dense tensor in the model dtype; its
    product is a plain matmul (ops/linear.py::qmatmul), as the JAX package
    computes it outside any Pallas kernel."""
    if kind == "F16":
        return (torch.randn((n, k), generator=generator, device=device) * 0.01).to(
            torch.bfloat16)
    return random_wire(kind, n, k, generator, device)


def ffn_width(cfg: ModelConfig, il: int = 0) -> int:
    """The dense FFN's width in layer il, by its tensors' rows: cfg.n_ff,
    or the layer's entry where feed_forward_length is a per-layer array
    (openelm, deci: the GGUF key in cfg.metadata; 0 for deci's FFN-free
    layers), but half of it for qwen (Qwen-1), whose feed_forward_length
    is twice the width of its ffn_gate/ffn_up tensors (llama.cpp creates
    them n_ff / 2 wide), and n_embd for arctic, whose dense residual MLP is
    as wide as the model (its feed_forward_length is the experts' width)."""
    if cfg.arch == "arctic":
        return cfg.n_embd
    per_layer = cfg.metadata.get(f"{cfg.arch}.feed_forward_length")
    if per_layer is not None and np.ndim(per_layer) == 1:  # a list, or a GGUF's array
        return int(per_layer[il])
    return cfg.n_ff // 2 if cfg.arch == "qwen" else cfg.n_ff


def _use_more_bits(i: int, n: int) -> bool:
    return i < n // 8 or i >= 7 * n // 8 or (i - n // 8) % 3 == 2


def shared_ff(cfg: ModelConfig) -> int:
    """The shared expert's width: its own key (qwen2moe), deepseek2's
    n_expert_shared experts side by side, or llama4's one shared expert of
    the routed experts' width (llama.cpp's llama4 tensors: ffn_*_shexp of
    n_ff_exp rows; its GGUF has no expert_shared_count)."""
    if cfg.arch == "llama4":
        return cfg.n_ff_exp
    return cfg.n_ff_shexp or cfg.n_ff_exp * cfg.n_expert_shared


def moe_layer(cfg: ModelConfig, il: int) -> bool:
    """Whether layer il routes experts: past deepseek2's leading dense
    layers, and under llama4's interleave (the GGUF key
    interleave_moe_layer_step: only the layers with (il + 1) % step == 0,
    the others dense of feed_forward_length, as Llama-4-Maverick's file)."""
    step = int(cfg.metadata.get(f"{cfg.arch}.interleave_moe_layer_step", 1) or 1)
    return cfg.n_expert > 0 and il >= cfg.n_layer_dense_lead and (il + 1) % step == 0


def tensor_kinds(cfg: ModelConfig, ftype: str = "Q4_K_M", imatrix: bool = False) -> dict:
    """The wire kind of every weight of a llama-family GGUF quantized to
    `ftype` (with an importance matrix if `imatrix`): {"token_embd",
    "output", "layers": [{attn_q, attn_k, attn_v, attn_output, ffn_gate,
    ffn_up, ffn_down}]} (the FFN names stand for the stacked experts in a
    MoE layer; a shared expert adds ffn_gate_shexp, ffn_up_shexp and
    ffn_down_shexp, the last by ffn_down's rule). phi3 and the families
    whose files fuse q/k/v (_FUSED_QKV_ARCHES) have one attn_qkv instead of
    q/k/v (Q5_K under Q4_K_M); an FFN without a gate (_UNGATED_ARCHES) has
    no ffn_gate; deepseek2's MLA layers have
    attn_q (or the q LoRA's attn_q_a and attn_q_b), attn_kv_a_mqa and
    attn_kv_b, which no rule names, and its leading dense layers (and
    llama4's interleaved ones, moe_layer) the dense FFN's. Unfused, by the GGUF
    tensor names. A tied embedding (cfg.tie_word_embeddings) takes the
    output tensor's rule, as in llama.cpp; "output" is then the kind of
    that table. Each kind is fitted to its row length (fit_kind)."""
    if ftype not in PRESETS:
        raise NotImplementedError(
            f"weight preset {ftype} is not ported yet (the port takes {', '.join(PRESETS)})")
    base, n, n_exp = PRESETS[ftype], cfg.n_layer, cfg.n_expert
    n_gqa = cfg.n_head // max(cfg.n_head_kv, 1)
    lowbit = ftype in LOWBIT_PRESETS
    iq2_sm = ftype in ("IQ2_S", "IQ2_M")  # take IQ3_S where the other 1-2 bpw presets Q2_K
    layers = []
    # llama.cpp counts attn_v and ffn_down by the tensors it has met (the
    # JAX quantizer's i_attn_v, i_ffn_down): deci's layers without
    # attention or without an FFN skip a count
    i_v = i_down = 0
    for il in range(n):
        h_l, hkv_l, ff_l = cfg.n_head_at(il), cfg.n_head_kv_at(il), ffn_width(cfg, il)
        i_d, i_a = il if n_exp > 1 else i_down, i_v
        i_v, i_down = i_v + (hkv_l > 0), i_down + (ff_l > 0)
        more, first8, more_v = _use_more_bits(i_d, n), i_d < n // 8, _use_more_bits(i_a, n)
        if lowbit:
            v = "Q4_K" if n_gqa >= 4 or n_exp >= 4 else "IQ3_S" if iq2_sm else "Q2_K"
            q, k = base, "Q4_K" if n_exp == 8 else base
            down = ("IQ3_S" if iq2_sm else "Q2_K") if first8 else base
            out = ("Q5_K" if n_exp == 8 else "IQ2_XXS" if ftype in ("IQ1_S", "IQ1_M")
                   else "IQ3_S" if iq2_sm else base)
        else:
            v = {"Q2_K": "Q4_K" if n_gqa >= 4 else "Q3_K",
                 "Q3_K_M": "Q5_K" if i_a < 2 else "Q4_K", "Q3_K_L": "Q5_K",
                 "Q4_K_M": "Q6_K" if more_v else base, "Q5_K_M": "Q6_K" if more_v else base,
                 "Q4_K_S": "Q5_K" if i_a < 4 else base,
                 "IQ3_XXS": "Q4_K" if n_gqa >= 4 else "IQ3_XXS" if imatrix else "IQ3_S",
                 "IQ3_XS": "Q4_K" if n_gqa >= 4 else base, "IQ3_S": "Q4_K" if n_gqa >= 4 else base,
                 "IQ3_M": "Q4_K", "IQ4_NL": "Q5_K" if n_gqa >= 4 else base,
                 "IQ4_XS": "Q5_K" if n_gqa >= 4 else base}.get(ftype, base)
            q = {"IQ3_XS": "IQ3_XXS", "IQ3_XXS": "IQ2_S"}.get(ftype, base)
            k = "Q8_0" if n_exp == 8 else q
            v = "Q8_0" if n_exp == 8 else v
            down = {"Q2_K": "Q3_K", "Q3_K_M": "Q5_K" if i_d < n // 16 else "Q4_K",
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
        E, q_width = cfg.n_embd, h_l * cfg.head_dim_v
        moe = moe_layer(cfg, il)
        f_down = (cfg.n_ff_exp or cfg.n_ff) if moe else ff_l
        lk = {"attn_q": fit_kind(q, E), "attn_k": fit_kind(k, E), "attn_v": fit_kind(v, E),
              "attn_output": fit_kind(out, q_width), "ffn_gate": fit_kind(base, E),
              "ffn_up": fit_kind(base, E), "ffn_down": fit_kind(down, f_down)}
        if cfg.arch in _FUSED_QKV_ARCHES:  # one attn_qkv tensor, by its own rule
            qkv = base if lowbit else {"Q3_K_M": "Q4_K", "Q3_K_L": "Q4_K", "IQ3_M": "Q4_K",
                                       "Q4_K_M": "Q5_K", "Q5_K_M": "Q6_K"}.get(ftype, base)
            del lk["attn_q"], lk["attn_k"], lk["attn_v"]
            lk["attn_qkv"] = fit_kind(qkv, E)
        if cfg.n_lora_kv:  # MLA: no attn_k/attn_v; its products take the default kind
            del lk["attn_k"], lk["attn_v"]
            if cfg.n_lora_q:
                del lk["attn_q"]
                lk.update(attn_q_a=fit_kind(base, E), attn_q_b=fit_kind(base, cfg.n_lora_q))
            lk.update(attn_kv_a_mqa=fit_kind(base, E), attn_kv_b=fit_kind(base, cfg.n_lora_kv))
        if cfg.arch in _UNGATED_ARCHES:
            del lk["ffn_gate"]
        if hkv_l == 0:  # deci: no attention, or attn_output alone ("linear attention")
            for key in ("attn_q", "attn_k", "attn_v", "attn_qkv",
                        *(("attn_output",) if h_l == 0 else ())):
                lk.pop(key, None)
        if not moe and ff_l == 0:  # deci's FFN-free layers
            for key in ("ffn_gate", "ffn_up", "ffn_down"):
                lk.pop(key, None)
        shexp = shared_ff(cfg) if moe else 0
        if shexp:
            lk.update(ffn_gate_shexp=lk["ffn_gate"], ffn_up_shexp=lk["ffn_up"],
                      ffn_down_shexp=fit_kind(down, shexp))
        layers.append(lk)
    embd = ("IQ3_S" if iq2_sm or ftype == "IQ3_XXS" else "Q2_K" if lowbit
            else "Q4_K" if ftype in ("TQ1_0", "TQ2_0") else base)
    # the LM head (or a tied embedding): Q8_0 where 256 does not divide its rows
    output = ("Q8_0" if cfg.n_embd % QK_K else "Q5_K" if lowbit or ftype == "IQ3_XXS"
              else "Q8_0" if base == "Q8_0" else "Q6_K")
    return {"token_embd": output if cfg.tie_word_embeddings else fit_kind(embd, cfg.n_embd),
            "output": output, "layers": layers}


def layout_kinds(cfg: ModelConfig, layout: str = DEFAULT_LAYOUT, imatrix: bool = False) -> dict:
    """tensor_kinds of a preset, or of DEFAULT_LAYOUT."""
    if layout != DEFAULT_LAYOUT:
        return tensor_kinds(cfg, layout, imatrix)
    kinds = tensor_kinds(cfg, "Q4_K_M")
    if not cfg.n_expert:
        for lk in kinds["layers"]:
            if "attn_v" in lk:
                lk["attn_v"] = fit_kind("Q6_K", cfg.n_embd)
    return kinds


def llama3_8b_config(n_layer: int = 32) -> ModelConfig:
    """Llama-3-8B geometry; `n_layer` cuts depth only."""
    return ModelConfig(
        arch="llama", n_vocab=128256, n_ctx_train=8192, n_embd=4096,
        n_layer=n_layer, n_head=32, n_head_kv=8, n_ff=14336,
        head_dim_k=128, head_dim_v=128,
        rope=RopeConfig(dim=128, freq_base=500000.0),
    )


def llama3_2_1b_config(n_layer: int = 16) -> ModelConfig:
    """Llama-3.2-1B (meta-llama/Llama-3.2-1B config.json: 16 layers, hidden
    2048, 32 heads over 8 kv heads of 64, intermediate 8192, rope_theta
    500000, tied embeddings, Llama-3's 128256-id vocab: the 8B's draft),
    with the llama3 rope scaling of its config (factor 32, low_freq_factor
    1, high_freq_factor 4, original_max_position_embeddings 8192), which
    llama.cpp's converter writes as the rope_freqs tensor
    (make_synthetic_params: llama3_rope_freqs); `n_layer` cuts depth only."""
    return ModelConfig(
        arch="llama", n_vocab=128256, n_ctx_train=131072, n_embd=2048,
        n_layer=n_layer, n_head=32, n_head_kv=8, n_ff=8192,
        head_dim_k=64, head_dim_v=64,
        rope=RopeConfig(dim=64, freq_base=500000.0), tie_word_embeddings=True,
        metadata={"rope_scaling": {"rope_type": "llama3", "factor": 32.0,
                                   "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                                   "original_max_position_embeddings": 8192}})


def llama3_rope_freqs(cfg: ModelConfig) -> torch.Tensor:
    """The rope_freqs tensor [dim / 2] f32 that llama.cpp's converter writes
    for a llama3 rope scaling (convert_hf_to_gguf.py, LlamaModel's
    generate_extra_tensors): 1 for the short wavelengths, the factor for
    the long ones, and between them 1 / ((1 - s) / factor + s) with s the
    smoothing of old_context_len / wavelength."""
    sc = cfg.metadata["rope_scaling"]
    dim, base = cfg.rope.dim or cfg.head_dim_k, cfg.rope.freq_base
    factor, low, high = sc["factor"], sc["low_freq_factor"], sc["high_freq_factor"]
    old = sc["original_max_position_embeddings"]
    freqs = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    out = []
    for freq in freqs.tolist():
        wavelen = 2 * math.pi / freq
        if wavelen < old / high:
            out.append(1.0)
        elif wavelen > old / low:
            out.append(factor)
        else:
            smooth = (old / wavelen - low) / (high - low)
            out.append(1 / ((1 - smooth) / factor + smooth))
    return torch.tensor(out, dtype=torch.float32)


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


def _family_config(arch: str, metadata=None, **fields) -> ModelConfig:
    """A ModelConfig of `arch` with the per-arch defaults a GGUF of it gets
    (config.py::_apply_arch_defaults; `metadata` the GGUF keys they read)."""
    cfg = ModelConfig(arch=arch, metadata=dict(metadata or {}), **fields)
    _apply_arch_defaults(cfg)
    return cfg


def qwen2_5_7b_config(n_layer: int = 28) -> ModelConfig:
    """Qwen2.5-7B (Qwen/Qwen2.5-7B-Instruct config.json: 28 layers, hidden
    3584, 28 query heads over 4 kv heads of 128, intermediate 18944, vocab
    152064, rope theta 1e6, rms eps 1e-6; q/k/v biases); `n_layer` cuts
    depth only."""
    return _family_config(
        "qwen2", n_vocab=152064, n_ctx_train=32768, n_embd=3584, n_layer=n_layer, n_head=28,
        n_head_kv=4, n_ff=18944, head_dim_k=128, head_dim_v=128, rms_norm_eps=1e-6,
        rope=RopeConfig(dim=128, freq_base=1e6))


def qwen2_5_0_5b_config(n_layer: int = 24) -> ModelConfig:
    """Qwen2.5-0.5B (Qwen/Qwen2.5-0.5B-Instruct config.json: 24 layers,
    hidden 896, 14 query heads over 2 kv heads of 64, intermediate 4864,
    vocab 151936, tied embeddings): every K = 896 row takes a 32-weight-block
    fallback kind; `n_layer` cuts depth only."""
    return _family_config(
        "qwen2", n_vocab=151936, n_ctx_train=32768, n_embd=896, n_layer=n_layer, n_head=14,
        n_head_kv=2, n_ff=4864, head_dim_k=64, head_dim_v=64, rms_norm_eps=1e-6,
        rope=RopeConfig(dim=64, freq_base=1e6), tie_word_embeddings=True)


def qwen3_8b_config(n_layer: int = 36) -> ModelConfig:
    """Qwen3-8B (Qwen/Qwen3-8B config.json: 36 layers, hidden 4096, 32 query
    heads over 8 kv heads of 128, intermediate 12288, vocab 151936, rope
    theta 1e6; per-head q/k norms); `n_layer` cuts depth only."""
    return _family_config(
        "qwen3", n_vocab=151936, n_ctx_train=40960, n_embd=4096, n_layer=n_layer, n_head=32,
        n_head_kv=8, n_ff=12288, head_dim_k=128, head_dim_v=128, rms_norm_eps=1e-6,
        rope=RopeConfig(dim=128, freq_base=1e6))


def qwen3_30b_a3b_config(n_layer: int = 48) -> ModelConfig:
    """Qwen3-30B-A3B (Qwen/Qwen3-30B-A3B config.json: 48 layers, hidden 2048,
    32 query heads over 4 kv heads of 128, so q is 4096 wide; 128 experts,
    top 8, moe_intermediate 768, norm_topk_prob true, vocab 151936); the
    top-k norm comes from the GGUF key, as a converted file carries it;
    `n_layer` cuts depth only."""
    return _family_config(
        "qwen3moe", {"qwen3moe.expert_weights_norm": True}, n_vocab=151936,
        n_ctx_train=40960, n_embd=2048, n_layer=n_layer, n_head=32, n_head_kv=4, n_ff=6144,
        head_dim_k=128, head_dim_v=128, rms_norm_eps=1e-6, n_expert=128, n_expert_used=8,
        n_ff_exp=768, expert_weights_norm=True, rope=RopeConfig(dim=128, freq_base=1e6))


def qwen2_57b_a14b_config(n_layer: int = 28) -> ModelConfig:
    """Qwen2-57B-A14B (Qwen/Qwen2-57B-A14B config.json: 28 layers, hidden
    3584, 28 query heads over 4 kv heads of 128, 64 experts, top 8,
    moe_intermediate 2560, a shared expert of 20480 with its sigmoid gate,
    norm_topk_prob false, vocab 151936; q/k/v biases); `n_layer` cuts depth
    only."""
    return _family_config(
        "qwen2moe", n_vocab=151936, n_ctx_train=32768, n_embd=3584, n_layer=n_layer,
        n_head=28, n_head_kv=4, n_ff=18944, head_dim_k=128, head_dim_v=128,
        rms_norm_eps=1e-6, n_expert=64, n_expert_used=8, n_ff_exp=2560, n_ff_shexp=20480,
        rope=RopeConfig(dim=128, freq_base=1e6))


def gemma2_9b_config(n_layer: int = 42) -> ModelConfig:
    """Gemma-2-9B (google/gemma-2-9b-it config.json: 42 layers, hidden 3584,
    16 query heads over 8 kv heads of 256, intermediate 14336, vocab 256000,
    sliding window 4096 on every other layer, attention softcap 50, final
    softcap 30, tied embeddings); `n_layer` cuts depth only."""
    return _family_config(
        "gemma2", n_vocab=256000, n_ctx_train=8192, n_embd=3584, n_layer=n_layer, n_head=16,
        n_head_kv=8, n_ff=14336, head_dim_k=256, head_dim_v=256, rms_norm_eps=1e-6,
        sliding_window=4096, attn_logit_softcap=50.0, final_logit_softcap=30.0,
        rope=RopeConfig(dim=256, freq_base=10000.0), tie_word_embeddings=True)


def gemma3_12b_config(n_layer: int = 48) -> ModelConfig:
    """Gemma-3-12B (google/gemma-3-12b-it config.json, text_config: 48 layers,
    hidden 3840, 16 query heads over 8 kv heads of 256, intermediate 15360,
    vocab 262208, sliding window 1024 on 5 of every 6 layers, rope theta 1e6
    with linear factor 8 on the global layers and 10000 on the local ones,
    per-head q/k norms, tied embeddings); `n_layer` cuts depth only."""
    return _family_config(
        "gemma3", n_vocab=262208, n_ctx_train=131072, n_embd=3840, n_layer=n_layer, n_head=16,
        n_head_kv=8, n_ff=15360, head_dim_k=256, head_dim_v=256, rms_norm_eps=1e-6,
        sliding_window=1024, rope=RopeConfig(dim=256, freq_base=1e6, scaling_type="linear",
                                             scaling_factor=8.0),
        tie_word_embeddings=True)


def gemma3_4b_config(n_layer: int = 34) -> ModelConfig:
    """Gemma-3-4B (google/gemma-3-4b-it config.json, text_config: 34 layers,
    hidden 2560, 8 query heads over 4 kv heads of 256, intermediate 10240,
    vocab 262208, window 1024, rope as Gemma-3-12B's): the smaller member
    whose head a CPU copy holds decoded; `n_layer` cuts depth only."""
    return _family_config(
        "gemma3", n_vocab=262208, n_ctx_train=131072, n_embd=2560, n_layer=n_layer, n_head=8,
        n_head_kv=4, n_ff=10240, head_dim_k=256, head_dim_v=256, rms_norm_eps=1e-6,
        sliding_window=1024, rope=RopeConfig(dim=256, freq_base=1e6, scaling_type="linear",
                                             scaling_factor=8.0),
        tie_word_embeddings=True)


def gemma_7b_config(n_layer: int = 28) -> ModelConfig:
    """Gemma-7B (google/gemma-7b config.json: 28 layers, hidden 3072, 16
    query heads over 16 kv heads of 256, so q is 4096 wide, intermediate
    24576, vocab 256000, rope theta 10000, rms eps 1e-6, GELU, tied
    embeddings); `n_layer` cuts depth only."""
    return _family_config(
        "gemma", n_vocab=256000, n_ctx_train=8192, n_embd=3072, n_layer=n_layer, n_head=16,
        n_head_kv=16, n_ff=24576, head_dim_k=256, head_dim_v=256, rms_norm_eps=1e-6,
        rope=RopeConfig(dim=256, freq_base=10000.0), tie_word_embeddings=True)


def phi3_5_mini_config(n_layer: int = 32) -> ModelConfig:
    """Phi-3.5-mini (microsoft/Phi-3.5-mini-instruct config.json: 32 layers,
    hidden 3072, 32 heads of 96 (no GQA), intermediate 8192, vocab 32064,
    rope theta 10000, rms eps 1e-5; longrope: 48 long and 48 short
    factors, original context 4096 of 131072). As llama.cpp's converter
    writes it: no rope scaling type (the factors are tensors, rope_long
    and rope_short) and rope.scaling.attn_factor sqrt(1 + ln 32 / ln 4096),
    which the JAX rope reads under YaRN only; its sliding_window of 262144
    is past any context here; `n_layer` cuts depth only."""
    return _family_config(
        "phi3", n_vocab=32064, n_ctx_train=131072, n_embd=3072, n_layer=n_layer, n_head=32,
        n_head_kv=32, n_ff=8192, head_dim_k=96, head_dim_v=96, rms_norm_eps=1e-5,
        rope=RopeConfig(dim=96, freq_base=10000.0, orig_ctx_len=4096,
                        attn_factor=math.sqrt(1 + math.log(32) / math.log(4096))))


def phi4_config(n_layer: int = 40) -> ModelConfig:
    """Phi-4 (microsoft/phi-4 config.json: 40 layers, hidden 5120, 40 query
    heads over 10 kv heads of 128, intermediate 17920, vocab 100352, rope
    theta 250000, rms eps 1e-5, no rope scaling, no window; GGUF arch
    phi3); `n_layer` cuts depth only."""
    return _family_config(
        "phi3", n_vocab=100352, n_ctx_train=16384, n_embd=5120, n_layer=n_layer, n_head=40,
        n_head_kv=10, n_ff=17920, head_dim_k=128, head_dim_v=128, rms_norm_eps=1e-5,
        rope=RopeConfig(dim=128, freq_base=250000.0))


def command_r_v01_config(n_layer: int = 40) -> ModelConfig:
    """Command-R (CohereForAI/c4ai-command-r-v01 config.json: 40 layers,
    hidden 8192, 64 heads of 128 (no GQA), intermediate 22528, vocab
    256000, layer norm eps 1e-5 without bias, rope theta 8e6, logit scale
    0.0625, tied embeddings, no q/k norm); `n_layer` cuts depth only."""
    return _family_config(
        "command-r", n_vocab=256000, n_ctx_train=8192, n_embd=8192, n_layer=n_layer,
        n_head=64, n_head_kv=64, n_ff=22528, head_dim_k=128, head_dim_v=128, norm_eps=1e-5,
        logit_scale=0.0625, rope=RopeConfig(dim=128, freq_base=8e6),
        tie_word_embeddings=True)


def command_r7b_config(n_layer: int = 32) -> ModelConfig:
    """Command R7B (CohereForAI/c4ai-command-r7b-12-2024 config.json: 32
    layers, hidden 4096, 32 query heads over 8 kv heads of 128,
    intermediate 14336, vocab 256000, layer norm eps 1e-5, rope theta
    50000, logit scale 0.25, sliding window 4096 on 3 of every 4 layers
    (the 4th global and without rope), tied embeddings); `n_layer` cuts
    depth only."""
    return _family_config(
        "cohere2", n_vocab=256000, n_ctx_train=8192, n_embd=4096, n_layer=n_layer, n_head=32,
        n_head_kv=8, n_ff=14336, head_dim_k=128, head_dim_v=128, norm_eps=1e-5,
        logit_scale=0.25, sliding_window=4096, rope=RopeConfig(dim=128, freq_base=50000.0),
        tie_word_embeddings=True)


def _deepseek2_rope() -> RopeConfig:
    """DeepSeek-V2's rope as llama.cpp's converter writes it: 64 rotary dims
    of the 192-wide key, YaRN factor 40 over 4096 original positions,
    yarn_log_multiplier 0.1 x mscale_all_dim 0.707 (the config's
    rope_scaling)."""
    return RopeConfig(dim=64, freq_base=10000.0, scaling_type="yarn", scaling_factor=40.0,
                      orig_ctx_len=4096, yarn_log_mul=0.0707)


def deepseek_v2_lite_config(n_layer: int = 27) -> ModelConfig:
    """DeepSeek-V2-Lite (deepseek-ai/DeepSeek-V2-Lite config.json: 27 layers,
    hidden 2048, 16 heads; MLA without a q LoRA, kv_lora_rank 512, key 128
    nope + 64 rope, value 128; layer 0 dense (intermediate 10944), the rest
    64 routed experts of 1408, top 6, softmax, no top-k norm, scale 1.0,
    beside 2 shared experts; vocab 102400, rms eps 1e-6); `n_layer` cuts
    depth only."""
    return _family_config(
        "deepseek2", n_vocab=102400, n_ctx_train=163840, n_embd=2048, n_layer=n_layer,
        n_head=16, n_head_kv=16, n_ff=10944, head_dim_k=192, head_dim_v=128,
        rms_norm_eps=1e-6, n_expert=64, n_expert_used=6, n_ff_exp=1408, n_expert_shared=2,
        n_lora_kv=512, n_layer_dense_lead=1, rope=_deepseek2_rope())


def deepseek_v2_config(n_layer: int = 60) -> ModelConfig:
    """DeepSeek-V2 (deepseek-ai/DeepSeek-V2 config.json: 60 layers, hidden
    5120, 128 heads; MLA with q_lora_rank 1536, kv_lora_rank 512, key 128 +
    64, value 128; layer 0 dense (intermediate 12288), the rest 160 routed
    experts of 1536, top 6, routed_scaling_factor 16, beside 2 shared
    experts; vocab 102400; its group-limited routing (8 groups, top 3) is
    not in the JAX router, which takes top-k over all experts); `n_layer`
    cuts depth only."""
    return _family_config(
        "deepseek2", n_vocab=102400, n_ctx_train=163840, n_embd=5120, n_layer=n_layer,
        n_head=128, n_head_kv=128, n_ff=12288, head_dim_k=192, head_dim_v=128,
        rms_norm_eps=1e-6, n_expert=160, n_expert_used=6, n_ff_exp=1536, n_expert_shared=2,
        expert_weights_scale=16.0, n_lora_q=1536, n_lora_kv=512, n_layer_dense_lead=1,
        rope=_deepseek2_rope())


def phi2_config(n_layer: int = 32) -> ModelConfig:
    """Phi-2 (microsoft/phi-2 config.json: 32 layers, hidden 2560, 32 heads
    of 80 (no GQA), intermediate 10240, partial_rotary_factor 0.4 (32 of
    80 dims), rope theta 10000, layer norm eps 1e-5, vocab 51200, 2048
    positions, untied; biases on every product, the LM head's included; one
    norm feeds the attention and the FFN in parallel); `n_layer` cuts depth
    only."""
    return _family_config(
        "phi2", n_vocab=51200, n_ctx_train=2048, n_embd=2560, n_layer=n_layer, n_head=32,
        n_head_kv=32, n_ff=10240, head_dim_k=80, head_dim_v=80, norm_eps=1e-5,
        rope=RopeConfig(dim=32, freq_base=10000.0))


def falcon_7b_config(n_layer: int = 32) -> ModelConfig:
    """Falcon-7B (tiiuae/falcon-7b config.json: 32 layers, hidden 4544, 71
    query heads of 64 over one kv head (multi_query), intermediate 4 x 4544
    = 18176, rope theta 10000, layer norm eps 1e-5, vocab 65024, no biases
    on the products, parallel_attn: one norm feeds both branches): K 4544
    rows take the 32-weight-block fallback kinds; `n_layer` cuts depth
    only."""
    return _family_config(
        "falcon", n_vocab=65024, n_ctx_train=2048, n_embd=4544, n_layer=n_layer, n_head=71,
        n_head_kv=1, n_ff=18176, head_dim_k=64, head_dim_v=64, norm_eps=1e-5,
        rope=RopeConfig(dim=64, freq_base=10000.0))


def falcon_40b_config(n_layer: int = 60) -> ModelConfig:
    """Falcon-40B (tiiuae/falcon-40b config.json: 60 layers, hidden 8192,
    128 query heads of 64 over 8 kv heads (new_decoder_architecture: the
    attention's own norm, attn_norm_2, beside attn_norm for the FFN),
    intermediate 32768, vocab 65024, no biases on the products); `n_layer`
    cuts depth only."""
    return _family_config(
        "falcon", n_vocab=65024, n_ctx_train=2048, n_embd=8192, n_layer=n_layer, n_head=128,
        n_head_kv=8, n_ff=32768, head_dim_k=64, head_dim_v=64, norm_eps=1e-5,
        rope=RopeConfig(dim=64, freq_base=10000.0))


def gpt2_config(n_layer: int = 12) -> ModelConfig:
    """GPT-2 (openai-community/gpt2 config.json: 12 layers, n_embd 768, 12
    heads of 64, n_inner 4 x 768 = 3072, 1024 learned positions, no rope,
    layer norm eps 1e-5, vocab 50257, tied embeddings, biases on every
    product); `n_layer` cuts depth only."""
    return _family_config(
        "gpt2", n_vocab=50257, n_ctx_train=1024, n_embd=768, n_layer=n_layer, n_head=12,
        n_head_kv=12, n_ff=3072, head_dim_k=64, head_dim_v=64, norm_eps=1e-5,
        rope=RopeConfig(dim=64), tie_word_embeddings=True)


def stablelm2_1_6b_config(n_layer: int = 24) -> ModelConfig:
    """StableLM-2-1.6B (stabilityai/stablelm-2-1_6b config.json: 24 layers,
    hidden 2048, 32 heads of 64, intermediate 5632 with a SiLU gate,
    partial_rotary_factor 0.25 (16 of 64 dims), rope theta 10000, layer
    norm eps 1e-5, q/k/v biases (use_qkv_bias), vocab 100352, 4096
    positions, untied); `n_layer` cuts depth only."""
    return _family_config(
        "stablelm", n_vocab=100352, n_ctx_train=4096, n_embd=2048, n_layer=n_layer, n_head=32,
        n_head_kv=32, n_ff=5632, head_dim_k=64, head_dim_v=64, norm_eps=1e-5,
        rope=RopeConfig(dim=16, freq_base=10000.0))


def starcoder2_7b_config(n_layer: int = 32) -> ModelConfig:
    """StarCoder2-7B (bigcode/starcoder2-7b config.json: 32 layers, hidden
    4608, 36 query heads of 128 over 4 kv heads, intermediate 18432 without
    a gate (GELU), rope theta 1e6, layer norm eps 1e-5, vocab 49152, biases
    on every product (use_bias), untied; its sliding_window of 4096 is left
    out: the JAX forward gives starcoder2 no window pattern); `n_layer` cuts
    depth only."""
    return _family_config(
        "starcoder2", n_vocab=49152, n_ctx_train=16384, n_embd=4608, n_layer=n_layer,
        n_head=36, n_head_kv=4, n_ff=18432, head_dim_k=128, head_dim_v=128, norm_eps=1e-5,
        rope=RopeConfig(dim=128, freq_base=1e6))


def starcoderbase_7b_config(n_layer: int = 42) -> ModelConfig:
    """StarCoderBase-7B (bigcode/starcoderbase-7b config.json: 42 layers,
    n_embd 4096, 32 query heads of 128 over one kv head (multi_query),
    n_inner 16384, 8192 learned positions, no rope, layer norm eps 1e-5,
    vocab 49152, tied embeddings, biases on every product); `n_layer` cuts
    depth only."""
    return _family_config(
        "starcoder", n_vocab=49152, n_ctx_train=8192, n_embd=4096, n_layer=n_layer,
        n_head=32, n_head_kv=1, n_ff=16384, head_dim_k=128, head_dim_v=128, norm_eps=1e-5,
        rope=RopeConfig(dim=128), tie_word_embeddings=True)


def pythia_6_9b_config(n_layer: int = 32) -> ModelConfig:
    """Pythia-6.9B (EleutherAI/pythia-6.9b config.json, GPT-NeoX: 32
    layers, hidden 4096, 32 heads of 128, intermediate 16384, rotary_pct
    0.25 (32 of 128 dims), rotary_emb_base 10000, layer norm eps 1e-5,
    use_parallel_residual (attn_norm for the attention, ffn_norm for the
    FFN), vocab 50432, untied, biases on every product); `n_layer` cuts
    depth only."""
    return _family_config(
        "gptneox", {"gptneox.use_parallel_residual": True}, n_vocab=50432, n_ctx_train=2048,
        n_embd=4096, n_layer=n_layer, n_head=32, n_head_kv=32, n_ff=16384, head_dim_k=128,
        head_dim_v=128, norm_eps=1e-5, rope=RopeConfig(dim=32, freq_base=10000.0))


def gptj_6b_config(n_layer: int = 28) -> ModelConfig:
    """GPT-J-6B (EleutherAI/gpt-j-6b config.json: 28 layers, n_embd 4096,
    16 heads of 256, n_inner 4 x 4096 = 16384, rotary_dim 64 of 256
    (interleaved pairs), layer norm eps 1e-5, vocab 50400, untied with a
    biased LM head; q/k/v and the output projection without biases, the
    FFN's with them; one norm feeds both branches); `n_layer` cuts depth
    only."""
    return _family_config(
        "gptj", n_vocab=50400, n_ctx_train=2048, n_embd=4096, n_layer=n_layer, n_head=16,
        n_head_kv=16, n_ff=16384, head_dim_k=256, head_dim_v=256, norm_eps=1e-5,
        rope=RopeConfig(dim=64, freq_base=10000.0))


def llama4_scout_config(n_layer: int = 48) -> ModelConfig:
    """Llama-4-Scout-17B-16E (meta-llama/Llama-4-Scout-17B-16E-Instruct
    config.json, text_config: 48 layers, hidden 5120, 40 query heads over 8
    kv heads of 128, 16 routed experts (top 1, sigmoid) of intermediate_size
    8192 beside one shared expert of the same width, interleave_moe_layer_step
    1 (every layer MoE), intermediate_size_mlp 16384 (the dense FFN width,
    unused here), vocab 202048, rope theta 5e5, rms eps 1e-5, attention
    chunk 8192, use_qk_norm, attention temperature floor 8192 / scale 0.1,
    untied). The defaults llama4 gets (config.py): chunked attention on 3 of
    every 4 layers, the 4th a NoPE layer. Its llama3 rope scaling (factor 16
    over 8192 original positions, the rope_freqs tensor of a converted file)
    is left out, as for the 8B; `n_layer` cuts depth only."""
    return _family_config(
        "llama4", n_vocab=202048, n_ctx_train=10485760, n_embd=5120, n_layer=n_layer,
        n_head=40, n_head_kv=8, n_ff=16384, head_dim_k=128, head_dim_v=128, rms_norm_eps=1e-5,
        n_expert=16, n_expert_used=1, n_ff_exp=8192, rope=RopeConfig(dim=128, freq_base=5e5))


def granite_3_1_8b_config(n_layer: int = 40) -> ModelConfig:
    """Granite-3.1-8B (ibm-granite/granite-3.1-8b-instruct config.json: 40
    layers, hidden 4096, 32 query heads over 8 kv heads of 128, intermediate
    12800, vocab 49155, rope theta 1e7, rms eps 1e-5, tied embeddings;
    embedding_multiplier 12, residual_multiplier 0.22, attention_multiplier
    1/128, logits_scaling 16, written as the GGUF keys embedding_scale,
    residual_scale, attention.scale and logit_scale, which config.py turns
    into a divisor); `n_layer` cuts depth only."""
    return _family_config(
        "granite", n_vocab=49155, n_ctx_train=131072, n_embd=4096, n_layer=n_layer,
        n_head=32, n_head_kv=8, n_ff=12800, head_dim_k=128, head_dim_v=128, rms_norm_eps=1e-5,
        embd_scale=12.0, residual_scale=0.22, attn_scale=1.0 / 128, logit_scale=16.0,
        rope=RopeConfig(dim=128, freq_base=1e7), tie_word_embeddings=True)


def granite_3_1_3b_a800m_config(n_layer: int = 32) -> ModelConfig:
    """Granite-3.1-3B-A800M (ibm-granite/granite-3.1-3b-a800m-instruct
    config.json: 32 layers, hidden 1536, 24 query heads over 8 kv heads of
    64, 40 experts (top 8, softmax) of intermediate 512, vocab 49155, rope
    theta 1e7, rms eps 1e-6, tied; multipliers 12 / 0.22 / attention 1/64,
    logits_scaling 6). A converted file has no expert_weights_norm key, so both packages
    route with unnormalized top-k weights (ROADMAP §3.14); `n_layer` cuts
    depth only."""
    return _family_config(
        "granitemoe", n_vocab=49155, n_ctx_train=131072, n_embd=1536, n_layer=n_layer,
        n_head=24, n_head_kv=8, n_ff=512, head_dim_k=64, head_dim_v=64, rms_norm_eps=1e-6,
        n_expert=40, n_expert_used=8, n_ff_exp=512, embd_scale=12.0, residual_scale=0.22,
        attn_scale=1.0 / 64, logit_scale=6.0, rope=RopeConfig(dim=64, freq_base=1e7),
        tie_word_embeddings=True)


def olmoe_1b_7b_config(n_layer: int = 16) -> ModelConfig:
    """OLMoE-1B-7B (allenai/OLMoE-1B-7B-0924 config.json: 16 layers, hidden
    2048, 16 heads of 128 (no GQA), 64 experts (top 8, softmax,
    norm_topk_prob false) of intermediate 1024, vocab 50304, rope theta
    10000, rms eps 1e-5, q/k norms over the whole projection, untied);
    `n_layer` cuts depth only."""
    return _family_config(
        "olmoe", {"olmoe.expert_weights_norm": False}, n_vocab=50304, n_ctx_train=4096,
        n_embd=2048, n_layer=n_layer, n_head=16, n_head_kv=16, n_ff=1024, head_dim_k=128,
        head_dim_v=128, rms_norm_eps=1e-5, n_expert=64, n_expert_used=8, n_ff_exp=1024,
        rope=RopeConfig(dim=128, freq_base=10000.0))


def olmo2_7b_config(n_layer: int = 32) -> ModelConfig:
    """OLMo-2-7B (allenai/OLMo-2-1124-7B config.json: 32 layers, hidden
    4096, 32 heads of 128 (no GQA), intermediate 11008, vocab 100352, rope
    theta 5e5, rms eps 1e-6, untied; no pre-norms: the attention and FFN
    outputs normed, q/k norms over the whole projection); `n_layer` cuts
    depth only."""
    return _family_config(
        "olmo2", n_vocab=100352, n_ctx_train=4096, n_embd=4096, n_layer=n_layer, n_head=32,
        n_head_kv=32, n_ff=11008, head_dim_k=128, head_dim_v=128, rms_norm_eps=1e-6,
        rope=RopeConfig(dim=128, freq_base=5e5))


def olmo_7b_config(n_layer: int = 32) -> ModelConfig:
    """OLMo-7B (allenai/OLMo-7B-0424-hf config.json: 32 layers, hidden 4096,
    32 heads of 128 (no GQA), intermediate 11008, vocab 50304, rope theta
    10000, clip_qkv 8 (the GGUF's attention.clamp_kqv), untied; the layer
    norms carry no weight or bias); `n_layer` cuts depth only."""
    return _family_config(
        "olmo", n_vocab=50304, n_ctx_train=4096, n_embd=4096, n_layer=n_layer, n_head=32,
        n_head_kv=32, n_ff=11008, head_dim_k=128, head_dim_v=128, norm_eps=1e-5,
        attn_clamp=8.0, rope=RopeConfig(dim=128, freq_base=10000.0))


def minicpm_2b_config(n_layer: int = 40) -> ModelConfig:
    """MiniCPM-2B (openbmb/MiniCPM-2B-sft-bf16 config.json: 40 layers, hidden
    2304, 36 heads of 64 (no GQA), intermediate 5760 (its ffn_down rows take
    the 32-weight-block fallback), vocab 122753, rope theta 10000, rms eps
    1e-5, tied; scale_emb 12, scale_depth 1.4, dim_model_base 256, which
    a converted file leaves to minicpm's defaults in config.py: embedding x
    12, residual x 1.4 / sqrt(40), logits x 256 / 2304); `n_layer` cuts depth
    only (the residual scale takes the cut depth, as a file of that depth
    would)."""
    return _family_config(
        "minicpm", n_vocab=122753, n_ctx_train=4096, n_embd=2304, n_layer=n_layer, n_head=36,
        n_head_kv=36, n_ff=5760, head_dim_k=64, head_dim_v=64, rms_norm_eps=1e-5,
        rope=RopeConfig(dim=64, freq_base=10000.0), tie_word_embeddings=True)


def bloom_7b1_config(n_layer: int = 30) -> ModelConfig:
    """BLOOM-7B1 (bigscience/bloom-7b1 config.json: n_layer 30, hidden_size
    4096, n_head 32 of 128, an FFN of 4 x 4096 = 16384 (GELU, no gate),
    vocab 250880, layer_norm_epsilon 1e-5, ALiBi and no rope, tied
    embeddings; biases on every product and norm, the embedding's layer
    norm, word_embeddings_layernorm, before the first layer); `n_layer`
    cuts depth only."""
    return _family_config(
        "bloom", n_vocab=250880, n_ctx_train=2048, n_embd=4096, n_layer=n_layer, n_head=32,
        n_head_kv=32, n_ff=16384, head_dim_k=128, head_dim_v=128, norm_eps=1e-5,
        rope=RopeConfig(dim=128), tie_word_embeddings=True)


def mpt_7b_config(n_layer: int = 32) -> ModelConfig:
    """MPT-7B (mosaicml/mpt-7b config.json: n_layers 32, d_model 4096, n_heads
    32 of 128, expansion_ratio 4 (an FFN of 16384, GELU, no gate), vocab
    50432, max_seq_len 2048, ALiBi with alibi_bias_max 8 and no rope,
    no_bias (no product or norm carries one), clip_qkv null, one fused Wqkv,
    tied embeddings); `n_layer` cuts depth only."""
    return _family_config(
        "mpt", n_vocab=50432, n_ctx_train=2048, n_embd=4096, n_layer=n_layer, n_head=32,
        n_head_kv=32, n_ff=16384, head_dim_k=128, head_dim_v=128, norm_eps=1e-5,
        max_alibi_bias=8.0, rope=RopeConfig(dim=128), tie_word_embeddings=True)


def jais_13b_config(n_layer: int = 40) -> ModelConfig:
    """Jais-13B (core42/jais-13b config.json: n_layer 40, n_embd 5120, n_head
    40 of 128, n_inner 13653 with a SwiGLU gate, vocab 84992, 2048
    positions, ALiBi and no rope, scale_qk_dot_by_d (a 1/128 attention
    scale: config.py), layer_norm_epsilon 1e-5, tied embeddings; biases on
    every product and norm). Its ffn_down rows of 13653 weights, which
    neither 256 nor 32 divides, are F16 in a llama.cpp file (fit_kind): a
    dense weight; 40 heads take both branches of ALiBi's slopes (heads
    32-39 the second); `n_layer` cuts depth only."""
    return _family_config(
        "jais", n_vocab=84992, n_ctx_train=2048, n_embd=5120, n_layer=n_layer, n_head=40,
        n_head_kv=40, n_ff=13653, head_dim_k=128, head_dim_v=128, norm_eps=1e-5,
        max_alibi_bias=8.0, rope=RopeConfig(dim=128), tie_word_embeddings=True)


def refact_1_6b_config(n_layer: int = 32) -> ModelConfig:
    """Refact-1.6B (smallcloudai/Refact-1_6B-fim config.json: n_layer 32,
    n_embd 2048, n_head 32 of 64 over one kv head (multi_query), a SwiGLU FFN
    of 5632, vocab 49216, 4096 positions, rms eps 1e-5, ALiBi (llama.cpp
    fixes the max bias at 8) and no rope, untied); `n_layer` cuts depth
    only."""
    return _family_config(
        "refact", n_vocab=49216, n_ctx_train=4096, n_embd=2048, n_layer=n_layer, n_head=32,
        n_head_kv=1, n_ff=5632, head_dim_k=64, head_dim_v=64, rms_norm_eps=1e-5,
        rope=RopeConfig(dim=64))


def xverse_7b_config(n_layer: int = 32) -> ModelConfig:
    """XVERSE-7B (xverse/XVERSE-7B config.json: 32 layers, hidden 4096, 32
    heads of 128 (no GQA), intermediate 11008, vocab 100534, 8192
    positions, rope theta 10000 (interleaved pairs in the GGUF), rms eps
    1e-6, untied); `n_layer` cuts depth only."""
    return _family_config(
        "xverse", n_vocab=100534, n_ctx_train=8192, n_embd=4096, n_layer=n_layer, n_head=32,
        n_head_kv=32, n_ff=11008, head_dim_k=128, head_dim_v=128, rms_norm_eps=1e-6,
        rope=RopeConfig(dim=128, freq_base=10000.0))


def baichuan2_7b_config(n_layer: int = 32) -> ModelConfig:
    """Baichuan2-7B (baichuan-inc/Baichuan2-7B-Base config.json: 32 layers,
    hidden 4096, 32 heads of 128, intermediate 11008, vocab 125696, 4096
    positions, rope theta 10000 (the 7B's rope; interleaved pairs in the
    GGUF), rms eps 1e-6, untied; llama.cpp's converter splits W_pack into
    q, k and v); `n_layer` cuts depth only."""
    return _family_config(
        "baichuan", n_vocab=125696, n_ctx_train=4096, n_embd=4096, n_layer=n_layer, n_head=32,
        n_head_kv=32, n_ff=11008, head_dim_k=128, head_dim_v=128, rms_norm_eps=1e-6,
        rope=RopeConfig(dim=128, freq_base=10000.0))


def internlm2_7b_config(n_layer: int = 32) -> ModelConfig:
    """InternLM2-7B (internlm/internlm2-7b config.json: 32 layers, hidden
    4096, 32 query heads over 8 kv heads of 128, intermediate 14336, vocab
    92544, rope theta 1e6 (interleaved pairs in the GGUF), rms eps 1e-5,
    untied; llama.cpp's converter splits wqkv into q, k and v); `n_layer`
    cuts depth only."""
    return _family_config(
        "internlm2", n_vocab=92544, n_ctx_train=32768, n_embd=4096, n_layer=n_layer, n_head=32,
        n_head_kv=8, n_ff=14336, head_dim_k=128, head_dim_v=128, rms_norm_eps=1e-5,
        rope=RopeConfig(dim=128, freq_base=1e6))


def exaone_3_7_8b_config(n_layer: int = 32) -> ModelConfig:
    """EXAONE-3.0-7.8B (LGAI-EXAONE/EXAONE-3.0-7.8B-Instruct config.json: 32
    layers, hidden 4096, 32 query heads over 8 kv heads of 128,
    intermediate 14336, vocab 102400, rope theta 500000 (NeoX pairs), rms
    eps 1e-5, untied); `n_layer` cuts depth only."""
    return _family_config(
        "exaone", n_vocab=102400, n_ctx_train=4096, n_embd=4096, n_layer=n_layer, n_head=32,
        n_head_kv=8, n_ff=14336, head_dim_k=128, head_dim_v=128, rms_norm_eps=1e-5,
        rope=RopeConfig(dim=128, freq_base=500000.0))


def orion_14b_config(n_layer: int = 40) -> ModelConfig:
    """Orion-14B (OrionStarAI/Orion-14B-Base config.json: 40 layers, hidden
    5120, 40 heads of 128 (no GQA), intermediate 15360 with a SiLU gate,
    vocab 84608, 4096 positions, rope theta 10000, layer norms with their
    biases at eps 1e-5, untied); `n_layer` cuts depth only."""
    return _family_config(
        "orion", n_vocab=84608, n_ctx_train=4096, n_embd=5120, n_layer=n_layer, n_head=40,
        n_head_kv=40, n_ff=15360, head_dim_k=128, head_dim_v=128, norm_eps=1e-5,
        rope=RopeConfig(dim=128, freq_base=10000.0))


def codeshell_7b_config(n_layer: int = 42) -> ModelConfig:
    """CodeShell-7B (WisdomShell/CodeShell-7B config.json: n_layer 42, n_embd
    4096, n_head 32 of 128 over num_query_groups 8, n_inner 16384 (GELU,
    no gate), vocab 70144, 8192 positions, rope theta 10000 (NeoX pairs),
    layer_norm_epsilon 1e-5; GPT-2's block: one biased c_attn, biases on
    every product and norm; untied); `n_layer` cuts depth only."""
    return _family_config(
        "codeshell", n_vocab=70144, n_ctx_train=8192, n_embd=4096, n_layer=n_layer, n_head=32,
        n_head_kv=8, n_ff=16384, head_dim_k=128, head_dim_v=128, norm_eps=1e-5,
        rope=RopeConfig(dim=128, freq_base=10000.0))


def qwen_7b_config(n_layer: int = 32) -> ModelConfig:
    """Qwen-7B, the first Qwen (Qwen/Qwen-7B config.json: 32 layers, hidden
    4096, 32 heads of 128, intermediate_size 22016, which llama.cpp writes
    as feed_forward_length and halves for ffn_gate/ffn_up's 11008 rows
    (ffn_width), vocab 151936, 8192 positions, rope theta 10000 (NeoX
    pairs), rms eps 1e-6, untied; one c_attn with its bias, no other
    bias); `n_layer` cuts depth only."""
    return _family_config(
        "qwen", n_vocab=151936, n_ctx_train=8192, n_embd=4096, n_layer=n_layer, n_head=32,
        n_head_kv=32, n_ff=22016, head_dim_k=128, head_dim_v=128, rms_norm_eps=1e-6,
        rope=RopeConfig(dim=128, freq_base=10000.0))


def plamo_13b_config(n_layer: int = 40) -> ModelConfig:
    """PLaMo-13B (pfnet/plamo-13b config.json: 40 layers, hidden 5120, 40
    heads of 128, which llama.cpp's converter writes over 5 kv heads
    (n_shared_head 8), intermediate 13824, vocab 50432, rope theta 10000,
    rms eps 1e-6, untied; one attn_norm feeds the attention and the FFN in
    parallel, and the file has no ffn_norm); `n_layer` cuts depth only."""
    return _family_config(
        "plamo", n_vocab=50432, n_ctx_train=4096, n_embd=5120, n_layer=n_layer, n_head=40,
        n_head_kv=5, n_ff=13824, head_dim_k=128, head_dim_v=128, rms_norm_eps=1e-6,
        rope=RopeConfig(dim=128, freq_base=10000.0))


def minitron_4b_config(n_layer: int = 32) -> ModelConfig:
    """Minitron-4B (nvidia/Minitron-4B-Base config.json, GGUF arch nemotron:
    32 layers, hidden 3072, 24 query heads over 8 kv heads of 128,
    intermediate 9216 with the squared ReLU and no gate,
    partial_rotary_factor 0.5 (64 of 128 dims), rope theta 10000, norm eps
    1e-5 (layer norms with their biases, the +1 of LayerNorm1P baked in by
    the converter), vocab 256000, untied, no product biases); `n_layer`
    cuts depth only."""
    return _family_config(
        "nemotron", n_vocab=256000, n_ctx_train=4096, n_embd=3072, n_layer=n_layer, n_head=24,
        n_head_kv=8, n_ff=9216, head_dim_k=128, head_dim_v=128, norm_eps=1e-5,
        rope=RopeConfig(dim=64, freq_base=10000.0))


def afm_4_5b_config(n_layer: int = 36) -> ModelConfig:
    """AFM-4.5B (arcee-ai/AFM-4.5B config.json, GGUF arch arcee: 36 layers,
    hidden 2560, 20 query heads over 4 kv heads of 128, intermediate 18432
    with the squared ReLU and no gate, vocab 128004, rope theta 10000
    (interleaved pairs in the GGUF), rms eps 1e-5, untied). Its YaRN rope
    scaling is left out, as the 8B's; `n_layer` cuts depth only."""
    return _family_config(
        "arcee", n_vocab=128004, n_ctx_train=4096, n_embd=2560, n_layer=n_layer, n_head=20,
        n_head_kv=4, n_ff=18432, head_dim_k=128, head_dim_v=128, rms_norm_eps=1e-5,
        rope=RopeConfig(dim=128, freq_base=10000.0))


def deepseek_moe_16b_config(n_layer: int = 28) -> ModelConfig:
    """DeepSeek-MoE-16B (deepseek-ai/deepseek-moe-16b-base config.json, GGUF
    arch deepseek: 28 layers, hidden 2048, 16 heads of 128 (no GQA), layer 0
    dense (first_k_dense_replace 1, intermediate 10944), the rest 64 routed
    experts of moe_intermediate 1408, top 6, softmax, norm_topk_prob false,
    scale 1.0, beside 2 shared experts; vocab 102400, rope theta 10000
    (interleaved pairs in the GGUF), rms eps 1e-6, untied); `n_layer` cuts
    depth only."""
    return _family_config(
        "deepseek", n_vocab=102400, n_ctx_train=4096, n_embd=2048, n_layer=n_layer, n_head=16,
        n_head_kv=16, n_ff=10944, head_dim_k=128, head_dim_v=128, rms_norm_eps=1e-6,
        n_expert=64, n_expert_used=6, n_ff_exp=1408, n_expert_shared=2, n_layer_dense_lead=1,
        rope=RopeConfig(dim=128, freq_base=10000.0))


def dots1_config(n_layer: int = 62) -> ModelConfig:
    """dots.llm1 (rednote-hilab/dots.llm1.base config.json: 62 layers, hidden
    4096, 32 heads of 128 (MHA-shaped k/v), per-head q/k rms norms, layer 0
    dense (intermediate 10944), the rest 128 routed experts of
    moe_intermediate 1408, top 6, sigmoid scores (noaux_tc) with the
    e_score_correction_bias as the selection bias, norm_topk_prob true,
    routed_scaling_factor 2.5, beside 2 shared experts; vocab 152064, rope
    theta 1e7, rms eps 1e-5, untied), as the GGUF keys expert_gating_func,
    expert_weights_norm and expert_weights_scale carry them; `n_layer` cuts
    depth only."""
    return _family_config(
        "dots1", n_vocab=152064, n_ctx_train=32768, n_embd=4096, n_layer=n_layer, n_head=32,
        n_head_kv=32, n_ff=10944, head_dim_k=128, head_dim_v=128, rms_norm_eps=1e-5,
        n_expert=128, n_expert_used=6, n_ff_exp=1408, n_expert_shared=2, n_layer_dense_lead=1,
        expert_gating_func="sigmoid", expert_weights_norm=True, expert_weights_scale=2.5,
        rope=RopeConfig(dim=128, freq_base=1e7))


def ling_lite_config(n_layer: int = 28) -> ModelConfig:
    """Ling-lite (inclusionAI/Ling-lite config.json, GGUF arch bailingmoe: 28
    layers, hidden 2048, 16 query heads over 4 kv heads of 128, every layer
    MoE (first_k_dense_replace 0; the intermediate 5632 of its config is
    unused), 64 routed experts of moe_intermediate 1408, top 6, softmax,
    norm_topk_prob true, beside 2 shared experts; vocab 126464, rope theta
    600000 (interleaved pairs in the GGUF), rms eps 1e-6, untied); `n_layer`
    cuts depth only."""
    return _family_config(
        "bailingmoe", n_vocab=126464, n_ctx_train=16384, n_embd=2048, n_layer=n_layer,
        n_head=16, n_head_kv=4, n_ff=5632, head_dim_k=128, head_dim_v=128, rms_norm_eps=1e-6,
        n_expert=64, n_expert_used=6, n_ff_exp=1408, n_expert_shared=2, expert_weights_norm=True,
        rope=RopeConfig(dim=128, freq_base=600000.0))


def phi3_5_moe_config(n_layer: int = 32) -> ModelConfig:
    """Phi-3.5-MoE (microsoft/Phi-3.5-MoE-instruct config.json, GGUF arch
    phimoe: 32 layers, hidden 4096, 32 query heads over 8 kv heads of 128,
    16 experts of intermediate 6400, top 2, softmax renormalized (the arch's
    default), vocab 32064, rope theta 10000, rms eps 1e-5; norms with their
    biases, which llama.cpp runs as rms norms plus the bias, q/k/v, output
    and LM head biases; longrope: 64 long and 64 short factors, original
    context 4096 of 131072, rope.scaling.attn_factor sqrt(1 + ln 32 / ln
    4096) as for Phi-3.5-mini, untied); `n_layer` cuts depth only."""
    return _family_config(
        "phimoe", n_vocab=32064, n_ctx_train=131072, n_embd=4096, n_layer=n_layer, n_head=32,
        n_head_kv=8, n_ff=6400, head_dim_k=128, head_dim_v=128, rms_norm_eps=1e-5,
        n_expert=16, n_expert_used=2,
        rope=RopeConfig(dim=128, freq_base=10000.0, orig_ctx_len=4096,
                        attn_factor=math.sqrt(1 + math.log(32) / math.log(4096))))


def grok_1_config(n_layer: int = 64) -> ModelConfig:
    """Grok-1 (xai-org/grok-1, its model.py and the config in run.py: 64
    layers, emb_size 6144, 48 query heads over 8 kv heads of 128, 8 experts
    of widening_factor 8 (32768 wide, GELU), top 2, vocab 131072, sequence
    length 8192, embedding multiplier 78.38, output multiplier 0.57735, the
    attention logits capped at 30; one in-out embedding table, so tied).
    Its rope theta (10000) and rms eps (1e-5) are the JAX package's
    defaults; the arch's defaults (config.py) give the scales, the fixed
    attention scale 1/sqrt(128), the softcap, GELU, the post-norms and the
    renormalized top 2; `n_layer` cuts depth only."""
    return _family_config(
        "grok", n_vocab=131072, n_ctx_train=8192, n_embd=6144, n_layer=n_layer, n_head=48,
        n_head_kv=8, n_ff=32768, head_dim_k=128, head_dim_v=128, rms_norm_eps=1e-5,
        n_expert=8, n_expert_used=2, rope=RopeConfig(dim=128, freq_base=10000.0),
        tie_word_embeddings=True)


def dbrx_config(n_layer: int = 40) -> ModelConfig:
    """DBRX (databricks/dbrx-base config.json: n_layers 40, d_model 6144,
    n_heads 48 over kv_n_heads 8 of 128, one fused Wqkv, clip_qkv 8, rope
    theta 500000, layer norms without a bias, 16 experts of ffn_hidden_size
    10752, top 4, vocab 100352, max_seq_len 32768, untied). Its layer-norm
    eps is the JAX default (1e-5). A converted file carries no
    expert_weights_norm key and the JAX package gives dbrx no default, so
    both packages route with unnormalized top-4 weights (llama.cpp's dbrx
    graph normalizes them); `n_layer` cuts depth only."""
    return _family_config(
        "dbrx", n_vocab=100352, n_ctx_train=32768, n_embd=6144, n_layer=n_layer, n_head=48,
        n_head_kv=8, n_ff=10752, head_dim_k=128, head_dim_v=128, norm_eps=1e-5,
        n_expert=16, n_expert_used=4, attn_clamp=8.0, rope=RopeConfig(dim=128, freq_base=5e5))


def arctic_config(n_layer: int = 35) -> ModelConfig:
    """Snowflake Arctic (Snowflake/snowflake-arctic-base config.json: 35
    layers, hidden 7168, 56 query heads over 8 kv heads of 128, 128 experts
    of intermediate 4864, top 2, renormalized (the arch's default), beside
    a dense residual MLP on every layer whose width is the hidden size
    (modeling_arctic's residual_mlp, llama.cpp's n_embd x n_embd ffn_gate,
    ffn_up and ffn_down); vocab 32000, rope theta 10000 (interleaved pairs
    in the GGUF), rms eps 1e-5, untied). Each layer runs the dense FFN as
    its sequential residual and the MoE FFN on the layer input, normed by
    ffn_norm_exps; `n_layer` cuts depth only."""
    return _family_config(
        "arctic", n_vocab=32000, n_ctx_train=4096, n_embd=7168, n_layer=n_layer, n_head=56,
        n_head_kv=8, n_ff=4864, head_dim_k=128, head_dim_v=128, rms_norm_eps=1e-5,
        n_expert=128, n_expert_used=2, rope=RopeConfig(dim=128, freq_base=10000.0))


def minicpm3_4b_config(n_layer: int = 62) -> ModelConfig:
    """MiniCPM3-4B (openbmb/MiniCPM3-4B config.json: 62 layers, hidden 2560,
    40 heads (num_key_value_heads 40); MLA with q_lora_rank 768,
    kv_lora_rank 256, qk_nope_head_dim 64 + qk_rope_head_dim 32 (key 96),
    v_head_dim 64; intermediate 6400, vocab 73448, rms eps 1e-5, rope theta
    10000 over the 32 rope dims with longrope factors (original context
    32768 of 32768: the short table at any context here); scale_emb 12,
    scale_depth 1.4, dim_model_base 256, which a converted file leaves to
    minicpm3's defaults in config.py: embedding x 12, logits x 256 / 2560,
    and a residual scale of 1.4 / sqrt(n_layer) that the MLA layers do not
    apply (the JAX forward's MLA branch); untied). The synthetic rope tables
    are make_synthetic_params' longrope pair, not the published factors;
    `n_layer` cuts depth only."""
    return _family_config(
        "minicpm3", n_vocab=73448, n_ctx_train=32768, n_embd=2560, n_layer=n_layer, n_head=40,
        n_head_kv=40, n_ff=6400, head_dim_k=96, head_dim_v=64, rms_norm_eps=1e-5,
        n_lora_q=768, n_lora_kv=256,
        rope=RopeConfig(dim=32, freq_base=10000.0, orig_ctx_len=32768))


def plm_1_8b_config(n_layer: int = 32) -> ModelConfig:
    """PLM-1.8B (PLM-Team/PLM-1.8B-Base config.json: 32 layers, hidden 2048,
    16 heads (num_key_value_heads 16); MLA without a q LoRA, kv_lora_rank
    512, qk_nope_head_dim 128 + qk_rope_head_dim 64 (key 192), v_head_dim
    128; an ungated squared-ReLU FFN of intermediate 8192; vocab 151936,
    rms eps 1e-6, rope theta 100000, tied embeddings); `n_layer` cuts depth
    only."""
    return _family_config(
        "plm", n_vocab=151936, n_ctx_train=4096, n_embd=2048, n_layer=n_layer, n_head=16,
        n_head_kv=16, n_ff=8192, head_dim_k=192, head_dim_v=128, rms_norm_eps=1e-6,
        n_lora_kv=512, rope=RopeConfig(dim=64, freq_base=100000.0), tie_word_embeddings=True)


def glm4_9b_0414_config(n_layer: int = 40) -> ModelConfig:
    """GLM-4-9B-0414 (THUDM/GLM-4-9B-0414 config.json: 40 layers, hidden
    4096, 32 query heads over 2 kv heads of 128, partial_rotary_factor 0.5
    (rope over 64 of the 128 dims, interleaved pairs), intermediate 13696
    (its ffn_down rows take the 32-weight-block fallback), vocab 151552,
    rms eps 1e-5, rope theta 10000, attention_bias (q/k/v biases), untied);
    llama.cpp's file holds the fused gate_up_proj as one ffn_up of 2 x 13696
    rows, and the post-attention and post-FFN norms beside the pre-norms;
    `n_layer` cuts depth only."""
    return _family_config(
        "glm4", n_vocab=151552, n_ctx_train=32768, n_embd=4096, n_layer=n_layer, n_head=32,
        n_head_kv=2, n_ff=13696, head_dim_k=128, head_dim_v=128, rms_norm_eps=1e-5,
        rope=RopeConfig(dim=64, freq_base=10000.0))


def glm_4_9b_chat_config(n_layer: int = 40) -> ModelConfig:
    """glm-4-9b-chat, GGUF arch chatglm (THUDM/glm-4-9b-chat config.json:
    num_layers 40, hidden_size 4096, 32 heads, multi_query_group_num 2,
    kv_channels 128, ffn_hidden_size 13696, padded_vocab_size 151552,
    layernorm_epsilon 1.5625e-07, rope_ratio 500 (llama.cpp's rope base
    10000 x 500), rope over half of each head, seq_length 131072,
    add_qkv_bias: one attn_qkv with its bias; the FFN one ffn_up of 2 x
    13696 rows, untied); `n_layer` cuts depth only."""
    return _family_config(
        "chatglm", n_vocab=151552, n_ctx_train=131072, n_embd=4096, n_layer=n_layer,
        n_head=32, n_head_kv=2, n_ff=13696, head_dim_k=128, head_dim_v=128,
        rms_norm_eps=1.5625e-07, rope=RopeConfig(dim=64, freq_base=5e6))


def chameleon_7b_config(n_layer: int = 32) -> ModelConfig:
    """Chameleon-7B (facebook/chameleon-7b config.json: 32 layers, hidden
    4096, 32 heads of 128 (no GQA), intermediate 11008, vocab 65536, rms eps
    1e-5, rope theta 10000, qk_layernorm (a layer norm of each head with
    [heads, 128] weights and biases, at eps 0 in llama.cpp's graph),
    swin_norm false, untied); the image tokens 4-8195 take -FLT_MAX in the
    logits; `n_layer` cuts depth only."""
    return _family_config(
        "chameleon", {"chameleon.swin_norm": False}, n_vocab=65536, n_ctx_train=4096,
        n_embd=4096, n_layer=n_layer, n_head=32, n_head_kv=32, n_ff=11008, head_dim_k=128,
        head_dim_v=128, rms_norm_eps=1e-5, rope=RopeConfig(dim=128, freq_base=10000.0))


def chameleon_30b_config(n_layer: int = 48) -> ModelConfig:
    """Chameleon-30B (facebook/chameleon-30b config.json: 48 layers, hidden
    8192, 64 query heads over 8 kv heads of 128, intermediate 22016, vocab
    65536, rms eps 1e-5, rope theta 10000, qk_layernorm, swin_norm true: no
    pre-norms, attn_norm and ffn_norm applied to the branch outputs);
    `n_layer` cuts depth only."""
    return _family_config(
        "chameleon", {"chameleon.swin_norm": True}, n_vocab=65536, n_ctx_train=4096,
        n_embd=8192, n_layer=n_layer, n_head=64, n_head_kv=8, n_ff=22016, head_dim_k=128,
        head_dim_v=128, rms_norm_eps=1e-5, rope=RopeConfig(dim=128, freq_base=10000.0))


def bitnet_b1_58_large_config(n_layer: int = 24) -> ModelConfig:
    """BitNet b1.58-large (1bitLLM/bitnet_b1_58-large config.json: 24
    layers, hidden 1536, 16 heads of 96 (no GQA), intermediate 4096, vocab
    32002, rms eps 1e-5, rope theta 10000; tied embeddings); llama.cpp's
    bitnet graph adds an rms sub-norm before attn_output and before
    ffn_down, and each product's one-element scale (attn_q, attn_k, attn_v,
    attn_output, ffn_gate, ffn_up, ffn_down .scale tensors). Its weights
    are ternary: the TQ1_0 and TQ2_0 presets, whose 256-weight blocks
    divide 1536 and 4096; `n_layer` cuts depth only."""
    return _family_config(
        "bitnet", n_vocab=32002, n_ctx_train=2048, n_embd=1536, n_layer=n_layer, n_head=16,
        n_head_kv=16, n_ff=4096, head_dim_k=96, head_dim_v=96, rms_norm_eps=1e-5,
        rope=RopeConfig(dim=96, freq_base=10000.0), tie_word_embeddings=True)


def _make_divisible(v: float, divisor: int) -> int:
    """OpenELM's make_divisible (the JAX converter's _make_divisible)."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def openelm_3b_config(n_layer: int = 36) -> ModelConfig:
    """OpenELM-3B (apple/OpenELM-3B config.json: 36 transformer layers,
    model_dim 3072, head_dim 128, num_gqa_groups 4, qkv_multipliers (0.5,
    1.0), ffn_multipliers (0.5, 4.0), ffn_dim_divisor 256, ffn_with_glu,
    vocab 32000, rope_freq_constant 10000, rms eps 1e-6, tied, q/k rms
    norms of each head). Each layer's multipliers are OpenELM's
    np.linspace over the 36 layers rounded to 2 decimals; its query heads
    make_divisible(3072 x m, 128 x 4) / 128 (12 to 24), its kv heads a
    quarter of them (3 to 6), its FFN width make_divisible(3072 x m, 256)
    (1536 to 12288): the arrays of the GGUF's head_count, head_count_kv and
    feed_forward_length. The cache holds the widest layer's 6 kv heads;
    `n_layer` keeps the first layers of the 36-layer schedule."""
    full = 36
    qkv_m = [round(float(v), 2) for v in np.linspace(0.5, 1.0, full)]
    ffn_m = [round(float(v), 2) for v in np.linspace(0.5, 4.0, full)]
    q_heads = [_make_divisible(3072 * m, 128 * 4) // 128 for m in qkv_m][:n_layer]
    kv_heads = [h // 4 for h in q_heads]
    ffn = [_make_divisible(m * 3072, 256) for m in ffn_m][:n_layer]
    return _family_config(
        "openelm", {"openelm.feed_forward_length": ffn}, n_vocab=32000, n_ctx_train=2048,
        n_embd=3072, n_layer=n_layer, n_head=max(q_heads), n_head_kv=max(kv_heads),
        n_ff=max(ffn), head_dim_k=128, head_dim_v=128, rms_norm_eps=1e-6,
        n_head_arr=tuple(q_heads), n_head_kv_arr=tuple(kv_heads),
        rope=RopeConfig(dim=128, freq_base=10000.0), tie_word_embeddings=True)


# the per-layer pattern of deci_51b_config, repeated over the depth: (query
# heads, kv heads, FFN width); kv heads 0 with query heads is a "linear
# attention" layer, with none an attention-free one; FFN width 0 an
# FFN-free layer
DECI_PATTERN = ((64, 8, 28672), (64, 2, 14336), (0, 0, 28672), (64, 0, 14336), (64, 0, 0),
                (64, 8, 14336))


def deci_51b_config(n_layer: int = 80) -> ModelConfig:
    """DeciLM at Llama-3.1-Nemotron-51B's global widths
    (nvidia/Llama-3_1-Nemotron-51B-Instruct config.json: 80 layers, hidden
    8192, 64 heads of 128, vocab 128256, rms eps 1e-5, rope theta 500000;
    its rope_scaling factors (rope_freqs) left out, untied) with a stated
    per-layer pattern, DECI_PATTERN, repeated: not the published
    block_configs, which the repository does not hold. The pattern holds
    every layer kind of that family: GQA attention at n_heads_in_group 8
    (8 kv heads) and 32 (2), an attention-free layer, "linear attention"
    layers (attn_output alone, replace_with_linear), an FFN-free layer, and
    FFN widths 28672 and 14336 from ffn_mult 5.25 and 2.625 by the JAX
    converter's _ffn_mult_to_intermediate_size rule (2 x mult x 8192 / 3,
    up to a multiple of 256). Every layer keeps its attn_norm (the JAX
    forward norms each layer's input before it looks at the layer's kind);
    an FFN-free layer has no ffn_norm. `n_layer` cuts depth only."""
    pat = [DECI_PATTERN[il % len(DECI_PATTERN)] for il in range(n_layer)]
    q_heads, kv_heads, ffn = ([p[i] for p in pat] for i in range(3))
    return _family_config(
        "deci", {"deci.feed_forward_length": ffn}, n_vocab=128256, n_ctx_train=131072,
        n_embd=8192, n_layer=n_layer, n_head=max(q_heads), n_head_kv=max(kv_heads),
        n_ff=max(ffn), head_dim_k=128, head_dim_v=128, rms_norm_eps=1e-5,
        n_head_arr=tuple(q_heads), n_head_kv_arr=tuple(kv_heads),
        rope=RopeConfig(dim=128, freq_base=500000.0))


# every synthetic configuration by the name the tools take (--model)
CONFIGS = {"llama3-8b": llama3_8b_config, "llama3-70b": llama3_70b_config,
           "llama3.2-1b": llama3_2_1b_config,
           "mixtral-8x7b": mixtral_8x7b_config, "qwen2.5-7b": qwen2_5_7b_config,
           "qwen2.5-0.5b": qwen2_5_0_5b_config, "qwen3-8b": qwen3_8b_config,
           "qwen3-30b-a3b": qwen3_30b_a3b_config, "qwen2-57b-a14b": qwen2_57b_a14b_config,
           "gemma2-9b": gemma2_9b_config, "gemma3-12b": gemma3_12b_config,
           "gemma3-4b": gemma3_4b_config, "gemma-7b": gemma_7b_config,
           "phi3.5-mini": phi3_5_mini_config, "phi4": phi4_config,
           "command-r-v01": command_r_v01_config, "command-r7b": command_r7b_config,
           "deepseek-v2-lite": deepseek_v2_lite_config, "deepseek-v2": deepseek_v2_config,
           "phi2": phi2_config, "falcon-7b": falcon_7b_config, "falcon-40b": falcon_40b_config,
           "gpt2": gpt2_config, "stablelm-2-1.6b": stablelm2_1_6b_config,
           "starcoder2-7b": starcoder2_7b_config, "starcoderbase-7b": starcoderbase_7b_config,
           "pythia-6.9b": pythia_6_9b_config, "gpt-j-6b": gptj_6b_config,
           "llama4-scout": llama4_scout_config, "granite-3.1-8b": granite_3_1_8b_config,
           "granite-3.1-3b-a800m": granite_3_1_3b_a800m_config,
           "olmoe-1b-7b": olmoe_1b_7b_config, "olmo2-7b": olmo2_7b_config,
           "olmo-7b": olmo_7b_config, "minicpm-2b": minicpm_2b_config,
           "bloom-7b1": bloom_7b1_config, "mpt-7b": mpt_7b_config, "jais-13b": jais_13b_config,
           "refact-1.6b": refact_1_6b_config, "xverse-7b": xverse_7b_config,
           "baichuan2-7b": baichuan2_7b_config, "internlm2-7b": internlm2_7b_config,
           "exaone-3-7.8b": exaone_3_7_8b_config, "orion-14b": orion_14b_config,
           "codeshell-7b": codeshell_7b_config, "qwen-7b": qwen_7b_config,
           "plamo-13b": plamo_13b_config, "minitron-4b": minitron_4b_config,
           "afm-4.5b": afm_4_5b_config, "deepseek-moe-16b": deepseek_moe_16b_config,
           "dots1": dots1_config, "ling-lite": ling_lite_config,
           "phi3.5-moe": phi3_5_moe_config, "grok-1": grok_1_config, "dbrx": dbrx_config,
           "arctic": arctic_config, "minicpm3-4b": minicpm3_4b_config,
           "plm-1.8b": plm_1_8b_config, "glm4-9b-0414": glm4_9b_0414_config,
           "glm-4-9b-chat": glm_4_9b_chat_config, "chameleon-7b": chameleon_7b_config,
           "chameleon-30b": chameleon_30b_config, "bitnet-b1.58-large": bitnet_b1_58_large_config,
           "openelm-3b": openelm_3b_config, "deci-51b": deci_51b_config}
# the families whose files carry q/k/v biases, and per-head q/k norms
_QKV_BIAS_ARCHES = ("qwen2", "qwen2moe", "stablelm", "starcoder2", "phimoe", "glm4")
_QK_NORM_ARCHES = ("qwen3", "qwen3moe", "gemma3", "dots1", "openelm")
# the files that hold q/k/v as one attn_qkv tensor, and the FFNs without a
# gate (act(up) -> down)
_FUSED_QKV_ARCHES = ("phi3", "phi2", "falcon", "gpt2", "starcoder", "gptneox", "bloom", "mpt",
                     "jais", "codeshell", "qwen", "dbrx", "chatglm", "openelm")
_UNGATED_ARCHES = ("phi2", "falcon", "gpt2", "starcoder", "starcoder2", "gptneox", "gptj",
                   "bloom", "mpt", "codeshell", "nemotron", "arcee", "plm")
# the biases of the products beside q/k/v's (llama.cpp's tensor lists of
# each arch; a fused attn_qkv's bias is q/k/v's): "output" is the LM head's
_GPT_BIASES = ("attn_qkv", "attn_output", "ffn_up", "ffn_down")
_BIASES = {"phi2": (*_GPT_BIASES, "output"), "gpt2": _GPT_BIASES, "starcoder": _GPT_BIASES,
           "gptneox": _GPT_BIASES, "starcoder2": ("attn_output", "ffn_up", "ffn_down"),
           "gptj": ("ffn_up", "ffn_down", "output"), "bloom": _GPT_BIASES,
           "codeshell": _GPT_BIASES, "jais": (*_GPT_BIASES, "ffn_gate"), "qwen": ("attn_qkv",),
           "phimoe": ("attn_output", "output"), "chatglm": ("attn_qkv",)}
# the families whose norms carry biases: the layer-norm families but
# command-r, mpt and dbrx, and phimoe's rms norms
_NORM_BIAS_ARCHES = ("phi2", "falcon", "gpt2", "starcoder", "starcoder2", "gptneox", "gptj",
                     "stablelm", "bloom", "jais", "orion", "codeshell", "nemotron", "phimoe")


def random_experts(kind: str, n_exp: int, n: int, k: int, generator: torch.Generator,
                   device=None) -> WireTensor:
    """A random stack of n_exp [n, k] experts, [n_exp, n, k]."""
    w = random_wire(kind, n_exp * n, k, generator, device)
    return WireTensor(kind, (n_exp, n, k), w.blocks)


def make_synthetic_params(cfg: ModelConfig, seed: int = 0, device=None,
                          ftype: str = DEFAULT_LAYOUT, imatrix: bool = False) -> dict:
    """Random params of a GGUF quantized to the preset `ftype` (with an
    importance matrix if `imatrix`), or laid out as DEFAULT_LAYOUT
    (layout_kinds), for the forward, on `device`, fused as the loader fuses
    such a file (convert.py: q/k/v of one kind fuse with their biases; q+k
    fuse unless q carries a bias or a norm; neither under olmo2's and
    olmoe's q/k norms over the whole projection, which are ones of the
    projections' widths; olmo has no norm tensor, olmo2 no attn_norm or
    ffn_norm; phi3's attn_qkv and its ffn_up
    of 2 x n_ff rows, which is ffn_gate_up; the fused attn_qkv of
    _FUSED_QKV_ARCHES). Norm weights are ones (and a parallel-residual arch
    has no ffn_norm, its FFN reading the attention's input norm, but
    gptneox, whose FFN has its own; falcon-40B's attention has its own
    attn_norm_2), biases, learned positions and routers small f32 draws,
    phi3's and phimoe's rope factors a long and a short table of
    cfg.rope.dim / 2. An arctic layer holds the dense FFN (ffn_gate_up and
    ffn_down, ffn_width wide) and its MoE branch's norm, ffn_norm_exps (ones,
    f32), beside the router and the experts; a dots1 MoE layer the
    selection bias exp_probs_b (small f32 draws)."""
    from .. import resolve_device

    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    kinds = layout_kinds(cfg, ftype, imatrix)
    E = cfg.n_embd
    bias, qk_norm = cfg.arch in _QKV_BIAS_ARCHES, cfg.arch in _QK_NORM_ARCHES
    qk_full = cfg.qk_norm_full  # olmo2, olmoe: q and k apart, each normed whole
    qk_layer = cfg.qk_norm_layer  # chameleon: per-head layer norms with biases
    scaled = cfg.arch == "bitnet"  # products apart, each with its scale
    biased = _BIASES.get(cfg.arch, ())

    def ones(n):
        return torch.ones(n, dtype=torch.float32, device=dev)

    def small(*shape):
        return torch.randn(shape, generator=g, device=dev) * 0.02

    def norm(tensors, key, n):
        if cfg.nonparam_norms:  # olmo's file has no norm tensor at all
            return
        tensors[key] = ones(n)
        if cfg.arch in _NORM_BIAS_ARCHES:
            tensors[key + "_b"] = small(n)

    def product(tensors, key, kind, n, k):
        tensors[key] = random_weight(kind, n, k, g, dev)
        if key in biased:
            tensors[key + "_b"] = small(n)
        if scaled:  # a one-element scale in the model dtype, as the loader keeps it
            tensors[key + "_scale"] = (1.0 + small(1)).to(torch.bfloat16)

    params: dict = {"tok_embd": random_wire(kinds["token_embd"], cfg.n_vocab, E, g, dev),
                    "layers": []}
    norm(params, "output_norm", E)
    if cfg.arch == "bloom":  # the embedding's layer norm
        params["tok_norm"], params["tok_norm_b"] = ones(E), small(E)
    if cfg.learned_pos_embd:  # gpt2, starcoder: dense, as a converted file holds it
        params["pos_embd"] = small(cfg.n_ctx_train, E)
    if not cfg.tie_word_embeddings:
        params["output"] = random_wire(kinds["output"], cfg.n_vocab, E, g, dev)
        if "output" in biased:
            params["output_b"] = small(cfg.n_vocab)
    if cfg.metadata.get("rope_scaling", {}).get("rope_type") == "llama3":
        params["rope_freqs"] = llama3_rope_freqs(cfg).to(dev)
    if cfg.arch in ("phi3", "phimoe", "minicpm3") and cfg.rope.orig_ctx_len:
        # longrope's two tables
        half = cfg.rope.dim // 2
        params["rope_short"] = 1.0 + torch.rand(half, generator=g, device=dev) * 0.1
        params["rope_long"] = torch.linspace(1.0, 40.0, half, device=dev)
    for il, lk in enumerate(kinds["layers"]):
        layer: dict = {}
        h_l, hkv_l, ff_l = cfg.n_head_at(il), cfg.n_head_kv_at(il), ffn_width(cfg, il)
        if not cfg.post_norm_only:  # olmo2 and chameleon's swin norm the branch outputs only
            norm(layer, "attn_norm", E)
        if cfg.arch == "falcon" and cfg.n_head_kv > 1:  # falcon-40B's second norm
            norm(layer, "attn_norm_2", E)
        if ((not cfg.parallel_residual or cfg.arch == "gptneox") and not cfg.post_norm_only
                and (ff_l or moe_layer(cfg, il))):
            norm(layer, "ffn_norm", E)
        kv = hkv_l * cfg.head_dim_k
        rows = {"attn_q": h_l * cfg.head_dim_k, "attn_k": kv, "attn_v": hkv_l * cfg.head_dim_v}
        if hkv_l == 0:  # deci: an attention-free layer, or attn_output alone
            pass
        elif cfg.n_lora_kv:  # the MLA of deepseek2, minicpm3 and plm
            Dk, r = cfg.head_dim_k, cfg.rope.dim
            if cfg.n_lora_q:
                layer["attn_q_a"] = random_wire(lk["attn_q_a"], cfg.n_lora_q, E, g, dev)
                layer["attn_q_a_norm"] = ones(cfg.n_lora_q)
                layer["attn_q_b_proj"] = random_wire(lk["attn_q_b"], cfg.n_head * Dk,
                                                     cfg.n_lora_q, g, dev)
            else:
                layer["attn_q"] = random_wire(lk["attn_q"], cfg.n_head * Dk, E, g, dev)
            layer["attn_kv_a_mqa"] = random_wire(lk["attn_kv_a_mqa"], cfg.n_lora_kv + r, E, g,
                                                 dev)
            layer["attn_kv_a_norm"] = ones(cfg.n_lora_kv)
            layer["attn_kv_b"] = random_wire(
                lk["attn_kv_b"], cfg.n_head * (Dk - r + cfg.head_dim_v), cfg.n_lora_kv, g, dev)
        elif "attn_qkv" in lk:
            product(layer, "attn_qkv", lk["attn_qkv"], sum(rows.values()), E)
        elif lk["attn_q"] == lk["attn_k"] == lk["attn_v"] and not (qk_full or scaled):
            layer["attn_qkv"] = random_wire(lk["attn_q"], sum(rows.values()), E, g, dev)
            if bias:
                layer["attn_qkv_b"] = small(sum(rows.values()))
        elif lk["attn_q"] == lk["attn_k"] and not (bias or qk_norm or qk_full or qk_layer
                                                   or scaled):
            layer["attn_qk"] = random_wire(lk["attn_q"], rows["attn_q"] + kv, E, g, dev)
            layer["attn_v"] = random_wire(lk["attn_v"], rows["attn_v"], E, g, dev)
        else:
            for key, n in rows.items():
                product(layer, key, lk[key], n, E)
                if bias:
                    layer[key + "_b"] = small(n)
        if hkv_l == 0:
            pass
        elif qk_norm:
            layer["attn_q_norm"], layer["attn_k_norm"] = ones(cfg.head_dim_k), ones(cfg.head_dim_k)
        elif qk_full:
            layer["attn_q_norm"], layer["attn_k_norm"] = ones(rows["attn_q"]), ones(kv)
        elif qk_layer:  # [heads, head_dim] weights and biases
            layer["attn_q_norm"] = ones(h_l * cfg.head_dim_k).reshape(h_l, -1)
            layer["attn_k_norm"] = ones(kv).reshape(hkv_l, -1)
            layer["attn_q_norm_b"] = small(h_l, cfg.head_dim_k)
            layer["attn_k_norm_b"] = small(hkv_l, cfg.head_dim_k)
        if scaled:  # bitnet's sub-norm before attn_output
            layer["attn_sub_norm"] = ones(h_l * cfg.head_dim_v)
        if "attn_output" in lk:
            product(layer, "attn_output", lk["attn_output"], E, h_l * cfg.head_dim_v)
        if cfg.post_norms:
            layer["attn_post_norm"], layer["ffn_post_norm"] = ones(E), ones(E)
        if moe_layer(cfg, il):
            n_exp, F = cfg.n_expert, cfg.n_ff_exp or cfg.n_ff
            if cfg.arch == "arctic":  # the dense FFN beside the MoE branch and its norm
                Fd = ffn_width(cfg)
                layer["ffn_gate_up"] = random_wire(lk["ffn_gate"], 2 * Fd, E, g, dev)
                layer["ffn_down"] = random_wire(lk["ffn_down"], E, Fd, g, dev)
                layer["ffn_norm_exps"] = ones(E)
            layer["ffn_gate_inp"] = small(n_exp, E)
            if cfg.arch == "dots1":  # the selection bias of its sigmoid router
                layer["exp_probs_b"] = small(n_exp)
            layer["ffn_gate_up_exps"] = random_experts(lk["ffn_gate"], n_exp, 2 * F, E, g, dev)
            layer["ffn_down_exps"] = random_experts(lk["ffn_down"], n_exp, E, F, g, dev)
            fs = shared_ff(cfg)
            if fs:
                if cfg.arch == "qwen2moe":  # deepseek2's and llama4's have no gate
                    layer["ffn_gate_inp_shexp"] = small(1, E)
                layer["ffn_gate_shexp"] = random_wire(lk["ffn_gate_shexp"], fs, E, g, dev)
                layer["ffn_up_shexp"] = random_wire(lk["ffn_up_shexp"], fs, E, g, dev)
                layer["ffn_down_shexp"] = random_wire(lk["ffn_down_shexp"], E, fs, g, dev)
        elif ff_l:
            F = ff_l
            if "ffn_gate" in lk and "ffn_gate" not in biased and not scaled:
                layer["ffn_gate_up"] = random_wire(lk["ffn_gate"], 2 * F, E, g, dev)
            elif "ffn_gate" in lk:  # jais, bitnet: a biased or scaled gate stays apart
                product(layer, "ffn_gate", lk["ffn_gate"], F, E)
                product(layer, "ffn_up", lk["ffn_up"], F, E)
            else:  # act(up) -> down
                product(layer, "ffn_up", lk["ffn_up"], F, E)
            if scaled:  # bitnet's sub-norm before ffn_down
                layer["ffn_sub_norm"] = ones(F)
            product(layer, "ffn_down", lk["ffn_down"], E, F)
        params["layers"].append(layer)
    return params


def synthetic_vocab(n_vocab: int = 128256):
    """An SPM vocab of Llama-3's size and special ids for a synthetic model
    served without a tokenizer file (requests send token ids): ids 0-255 are
    the byte tokens <0x00>..<0xFF>, 256-127999 the plain tokens "<tN>" (no
    piece is part of another, so a piece makes an unambiguous stop string),
    128000 <|begin_of_text|> (BOS), 128001 <|end_of_text|> (EOS), 128009
    <|eot_id|> (EOT: end of generation with EOS) and the rest reserved
    control tokens, as in Llama-3's vocab. A vocab under 128010 ids ends
    its plain tokens 10 ids early instead, so its last ten are the special
    ones. The JSON grammars match the byte tokens only."""
    from ..tokenizer import Vocab

    bos = min(128000, n_vocab - 10)
    names = {bos: "<|begin_of_text|>", bos + 1: "<|end_of_text|>", bos + 9: "<|eot_id|>"}
    tokens = [f"<0x{i:02X}>" for i in range(256)]
    tokens += [f"<t{i}>" for i in range(256, bos)]
    tokens += [names.get(i, f"<|reserved_special_token_{i - bos}|>") for i in range(bos, n_vocab)]
    types = [6] * 256 + [1] * (bos - 256) + [3] * (n_vocab - bos)
    return Vocab.from_metadata({
        "tokenizer.ggml.model": "llama", "tokenizer.ggml.tokens": tokens,
        "tokenizer.ggml.token_type": types, "tokenizer.ggml.bos_token_id": bos,
        "tokenizer.ggml.eos_token_id": bos + 1, "tokenizer.ggml.eot_token_id": bos + 9})
