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
     4-row cache; and the Qwen and Gemma families' shapes: qmv (1 and 4
     rows) and qgemm on Qwen2.5-0.5B's padded Q5_0 and Q8_0 weights (K =
     896, rows padded with zero blocks to 1024), the families' projections
     (Qwen2.5-7B's
     biased attn_q alone, Qwen3's q + k + v launch, Gemma-3-12B's gate_up
     and tied Q6_K head), K4 and K5 at Gemma's heads (16 over 8, D 256,
     softcap 50, window 4096), Qwen2.5's (28 over 4) and the 0.5B's (14
     over 2, D 64), K6 and K7 over q8_0 planes at Gemma's, and K10 and
     K11 at Qwen3-30B-A3B's experts (128, top 8: 8 and 32 rows, 128- and
     512-token prefills); and the DeepSeek, Phi-3, Command-R and Gemma-1
     shapes: K1-K3 on the MLA weights (q with the compressed kv in one
     launch, V2's q LoRA, attn_kv_b at K 512), DeepSeek-V2-Lite's dense
     ffn_down at K 10944 (Q8_0, padded) and its shared experts' launch,
     Phi-3.5's Q5_K attn_qkv, Command-R's tied 256000-row head; K4-K7 at
     MLA's K 192 / V 128 (16 and 128 heads, one a kv head: K5/K7's
     192/128 tiles), at Phi-3.5's D 96, at Command-R's 64 heads and
     Gemma-7B's 16 of 256; K10/K11 on DeepSeek-V2-Lite's 64 experts top 6
     (down 64x2048x1408 in Q5_0 and Q8_0, padded) and V2's 160; and the
     layer-norm families' shapes: K1/K2 on Falcon-7B's K-4544 rows in their
     32-weight-block kinds and its K-18176 ffn_down, Phi-2's biased
     attn_qkv, GPT-J's q+k+v launch; multi-query heads, K4 and K6 (q8_0)
     at 71 query heads over one kv head of 64 (Falcon-7B), 48 and 32 over
     one of 128 (StarCoder-15B, StarCoderBase-7B), at depths 1000 and 32765,
     K5 and K7 at rep 71 from offsets 0 and 896; K4/K5 at Phi-2's D 80;
     and Llama 4's, the OLMo and the scaled families' shapes: K1 on
     Llama-4-Scout's 202048-row Q6_K head and Granite-3.1-8B's tied one,
     K3 on Scout's q+k with v and on OLMo-2's and OLMoE's q, k and v apart,
     K10 (1 and 4 tokens: Scout's top 1 gives S = 1) and K11 (a 128-token
     prefill) at Scout's 16 experts, OLMoE's 64 and Granite-3.1-3B-A800M's
     40; and the ALiBi families', the clones' and relu^2's: K1 on
     BLOOM-7B1's tied 250880-row Q6_K head, K1/K2 on its biased attn_qkv,
     Jais-13B's biased 13653-row gate and Qwen-7B's gate_up (2 x 11008
     rows, its tensors' width); K4/K5 at PLaMo-13B's 40 heads over 5; and
     the MoE variants': K1 on dots.llm1's 152064-row and Grok-1's tied
     131072-row Q6_K heads, K1/K2 on DBRX's fused attn_qkv, K4/K5 at
     Grok-1's 48 heads over 8 with softcap 30 at its fixed scale and at
     Snowflake Arctic's 56 over 8, K10 (1 and 4 tokens) and K11 (a
     128-token prefill) at Arctic's 128 experts of 4864 over 7168 (top 2),
     DBRX's 16 of 10752 (top 4), Grok-1's 8 of 32768 (its down at K 32768)
     and dots.llm1's 128 of 1408 (top 6, down padded to 1536); and the
     last decoders': K1/K2 on GLM-4-9B-0414's 27392-row fused gate_up and
     its ffn_down at K 13696 (32-block fallback), K3 on MiniCPM3-4B's q
     LoRA with the compressed kv and K1/K2 on its q decompression at K 768,
     K1/K2 on BitNet b1.58-large's ternary rows (TQ2_0 and TQ1_0 at K 1536
     and 4096), K4-K7 at MiniCPM3's MLA heads (K 96 / V 64, 40 over 40: the
     96/64 tiles) and K4/K5 at GLM-4's 32 query heads over 2; and
     speculative decoding's verify over the 128256-row Q6_K head: K1 at 5
     rows and K2 at 32;
  4. the full-width kernel path (8B widths, 2 layers) against the plain
     path (the same params on the CPU): prefill logits, 4 teacher-forced
     decode steps (Engine.decode_one: replays of the step's CUDA graph on
     the card, the same step run eagerly on the CPU) and a 9-token second
     chunk, with the dense cache, q8_0,
     the split q5_1:q4_0 cache, LLAMACOG_MMQ=1 on a 300-token prompt (int8
     prefill), and the per-layer decode routes (LLAMACOG_FLASH_STACKED=0:
     K9 on the dense cache with LLAMACOG_FLASH_DECODE=1, K8 on q8_0);
     speculative decoding's verify forwards, the logits of every position
     of a target step at T = 5 (K1 at 5 rows) and T = 9 (K2) and of
     Engine.prefill_logits (9 tokens, the 32-row bucket), and one
     on-device speculative round (1-layer self-draft, k = 4) captured as a
     CUDA graph against its eager run, bit for bit; and the presets Q4_0 (with LLAMACOG_MMQ=1), Q5_1, Q3_K_M, Q2_K, IQ4_XS,
     IQ3_XXS and IQ1_M; then the same at Mixtral widths (2 layers, dense
     cache, the attention weight kinds of a real Q4_K_M file: Q8_0
     attn_k/attn_v, Q5_K attn_output): a 20-token prefill (grouped GEMM), 4
     decode steps and a 9-token second chunk (gather), and at 1 layer the
     presets Q5_K_M, Q3_K_M, IQ2_M, IQ3_XXS (an f32 model: see phase 4's
     comment) and TQ1_0 (the CPU copy keeps each weight's plain dequant, made on the
     card: wire.keep_decoded's form); and a 4-row engine (8B widths, dense
     and q8_0; Mixtral widths, dense): row prefills of 20, 9 and 33 tokens,
     decode steps with inactive rows, a shift_row, each row of the bf16
     model held against single-stream engines on the card, and the kernel
     path against the plain path (the 8B as an f32 model); then each of
     the six new families at 2 layers of its config's widths: Qwen2.5-7B,
     Qwen2.5-0.5B, Qwen3-8B, Qwen3-30B-A3B,
     Qwen2-57B-A14B (1 layer), Gemma-2-9B (max_seq 8192: the ring; and q8_0) and
     Gemma-3 at Gemma-3-4B's widths and 6 layers (one global), an
     1100-token prompt past its 1024-token window at max_seq 1280 (the ring
     wraps; the decode steps and the second chunk read it); then the
     DeepSeek, Phi-3, Command-R and Gemma-1 families at 2 layers (DeepSeek:
     the dense lead layer and a MoE one): DeepSeek-V2-Lite (dense and
     q8_0), DeepSeek-V2, Phi-3.5-mini (dense and q8_0), Command-R,
     Gemma-7B, and Command R7B at 4 layers (its 4th global and without
     rope; the ring at max_seq 8192); then the layer-norm families at 2
     layers: Falcon-7B (dense and q8_0: rep 71), Phi-2 (dense: K4/K5 at D
     80; q8_0: the masked path, no attention kernel, the JAX route), GPT-2,
     StableLM-2-1.6B, StarCoder2-7B, StarCoderBase-7B (q8_0: rep 32),
     Pythia-6.9B, GPT-J-6B and Falcon-40B (StableLM-2, StarCoder2,
     StarCoderBase and GPT-J as f32 models: see phase 4's comment); then
     Llama 4, the OLMo and the scaled families at 2 layers:
     Llama-4-Scout at 1 (chunked attention: the masked path, no attention
     kernel; a 40-token prompt for the grouped GEMM at top 1),
     Granite-3.1-8B (dense and q8_0), OLMoE-1B-7B, OLMo-2-7B (dense and
     q8_0), OLMo-7B, Granite-3.1-3B-A800M and MiniCPM-2B; then the ALiBi
     families at 2 layers, every layer through the masked path with the
     slopes and distances (no attention kernel, the JAX route): BLOOM-7B1
     (dense and q8_0), MPT-7B, Jais-13B (its F16 ffn_down at K 13653 a
     dense product) and Refact-1.6B (32 query heads over one); the
     llama-graph clones XVERSE-7B, Baichuan2-7B, InternLM2-7B,
     EXAONE-3.0-7.8B, Orion-14B, CodeShell-7B, Qwen-7B and PLaMo-13B, and
     the squared-ReLU Minitron-4B and AFM-4.5B (BLOOM-7B1, MPT-7B, Jais-13B,
     Orion-14B and CodeShell-7B as f32 models: see phase 4's comment); then
     the MoE variants: DeepSeek-MoE-16B, dots.llm1 (dense and q8_0; the
     forced routing repeats its selection bias), Ling-lite and Phi-3.5-MoE
     at 2 layers, DBRX at 1 (dense and q8_0, as an f32 model: see phase 4's
     comment), Grok-1 at 1 and Snowflake Arctic at 1 with its 128 experts
     cut to 16 (the CPU copy of one layer's 128 would hold ~54 GB decoded);
     then the last decoders: MiniCPM3-4B (dense and q8_0), PLM-1.8B,
     GLM-4-9B-0414 (as an f32 model: see phase 4's comment),
     glm-4-9b-chat, Chameleon-7B and BitNet b1.58-large in
     TQ2_0 and TQ1_0 at 4 layers, the swin Chameleon-30B at 2, OpenELM-3B
     at 8 of its 36 layers (dense and q8_0) and the deci pattern at
     Nemotron-51B's widths over 5 layers (dense and q8_0), the last two on
     the masked path on every layer (no attention kernel, the JAX route);
     chameleon's -FLT_MAX image-token logits must agree between the paths
     and are left out of the error;
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
     decode_one), run twice, must draw the same tokens; speculative
     decoding on the device (OnDeviceSpeculative, k = 4, one graph a round:
     the full-depth self-draft and a 4-layer one, 128 tokens, the round's
     launches the captured ones times the replays), host-driven with a
     draft of Llama-3.2-1B's shape (greedy; seeded sampling twice, the same
     tokens), the greedy tokens equal to the plain ones or parting first at
     a near-tie of the plain logits; a state round trip, dense and q8_0
     (the continuation after restore equals the uninterrupted one); the
     server with -md and slot save/restore; then, with the
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
     q8_0; every decode step a graph replay); then the Qwen and Gemma
     families in Q4_K_M through the graph, 64 greedy tokens: Qwen2.5-7B,
     Qwen3-30B-A3B (and a 512-token prompt, 16 tokens), Gemma-3-12B (a
     1536-token prompt in two chunks at max_seq 2048: the ring wraps) and
     Qwen2.5-0.5B at full depth, Qwen3-8B, Gemma-2-9B
     (max_seq 8192: the ring, the full store with kv bf16, and q8_0) and
     Qwen2-57B-A14B at 4 layers, and a Gemma-3-12B serving run (4 slots,
     ctx 4096: the ring; 5 greedy requests, three sharing a 512-token
     prefix: a ring slot is prefilled anew, never truncated); then
     DeepSeek-V2-Lite at full depth (27 layers; dense and q8_0, and a
     512-token prompt in one step), DeepSeek-V2 at 2 layers, Phi-3.5-mini
     at full depth (dense and q8_0), Command-R and Gemma-7B at 4 layers,
     and Command R7B at 4 layers with a 4352-token prompt past its 4096
     window (max_seq 8192: the ring wraps); each family run's attention
     launches one a layer and chunk (prefill) and token (decode), on the
     global layers alone over a ring; then the layer-norm families, 64
     greedy tokens each: Phi-2 at full depth (32 layers; dense, and q8_0,
     which launches no K6/K7: the masked path at D 80) and a Phi-2 serving
     run (4 slots, ctx 4096, 5 greedy requests, each held against one
     stream through a 4-row engine), Falcon-7B at full depth (32 layers; dense, which launches K4
     and K5, q8_0, which launches K6 and K7, at 71 query heads a kv head,
     and a 512-token prompt), GPT-2 (12 layers) and StableLM-2-1.6B (24)
     at full depth, StarCoder2-7B, StarCoderBase-7B (dense and q8_0),
     Pythia-6.9B and GPT-J-6B at 4 layers and Falcon-40B at 2; then
     Granite-3.1-8B at full depth (40 layers, dense and q8_0), OLMoE-1B-7B
     at full depth (16), OLMo-2-7B, OLMo-7B, Granite-3.1-3B-A800M and
     MiniCPM-2B at 4 layers, and Llama-4-Scout-17B-16E at full depth (48
     layers: every layer through the masked path, which launches no
     attention kernel, checked); then BLOOM-7B1 at full depth (30 layers,
     dense and q8_0: the masked path on every layer, no attention kernel,
     checked; four decode steps' logits replayed from the graph held bit
     for bit against the eager step's), and MPT-7B, Jais-13B, Refact-1.6B,
     Orion-14B, CodeShell-7B, Qwen-7B, PLaMo-13B and Minitron-4B at 4
     layers; then DeepSeek-MoE-16B at full depth (28 layers) and dots.llm1,
     Ling-lite, Phi-3.5-MoE, Grok-1, DBRX and Snowflake Arctic at 4 layers
     (Arctic's replayed step's logits held bit for bit against its eager
     step's); then GLM-4-9B-0414 (40 layers), OpenELM-3B (36: the masked
     path on every layer, no attention kernel, checked; its replayed step
     bit for bit against the eager step), MiniCPM3-4B (62; dense and q8_0)
     and BitNet b1.58-large in TQ2_0 and TQ1_0 (24) at full depth, each
     with its ms/token, TTFT, peak memory and launches a token beside the
     card's name and power limit; the phase's wall time;
  6. each phase's seconds, one JSON line of per-kernel results, the card's
     name and power limit, and the final {"ok": true, ...} line.

Weights are random wire blocks made on the card from a seed, each tensor of
the kind llama.cpp's rules give it under the run's preset (Q4_K_M unless
named; utils/synthetic.py; the IQ presets with an importance matrix, as the
public files are made).
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
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
NEG_FLT_MAX = -3.4028234663852886e38  # chameleon's suppressed image tokens (-FLT_MAX)
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
# the batched MoE decodes of phase 5: Mixtral at 8 rows a step (16 (token,
# slot) rows a product over 8 experts: K10 groups them by expert), and
# Qwen3-30B-A3B at SERVING_SLOTS (32 over 128: a block per row)
MIXTRAL_BATCH = 8
MIXTRAL_BATCH_RUN = f"mixtral batch {MIXTRAL_BATCH}"
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
    from llamacog_tpu_torch.models.llama import _MOE_GATHER_MAX, _ffn_moe, moe_sort
    from llamacog_tpu_torch.ops.linear import qmatmul
    from llamacog_tpu_torch.ops.cuda.qmm import qgemm, qmm_plain, qmv
    from llamacog_tpu_torch.ops.cuda.qmm_i8 import (
        qmm_i8_kernel, qmm_i8_plain, qmm_i8_tile_rows, quantize_activations, quantize_kernel)
    from llamacog_tpu_torch.ops.cuda.qmm_id import (
        RAGGED_TILE, gather_groups, qmm_gather, qmm_gather_offset, qmm_gather_plain, qmm_ragged,
        qmm_ragged_plain)
    from llamacog_tpu_torch.ops.linear import qmatmul_multi
    from llamacog_tpu_torch.quant.mmq import build_mmq_planes
    from llamacog_tpu_torch.quant.wire import CODEBOOK_KINDS, LOW_BIT_KINDS, WireTensor, dequantize
    from llamacog_tpu_torch.runtime.engine import Engine
    from llamacog_tpu_torch.runtime.kv_cache import (
        QuantKVCache, kv_dequant_planes, kv_plane_shapes)
    from llamacog_tpu_torch.runtime.sampler import SamplerChain, SamplerParams
    from llamacog_tpu_torch.runtime.speculative import (
        OnDeviceSpeculative, SpeculativeDecoder, SpeculativeParams, truncated_draft_params)
    from llamacog_tpu_torch.runtime.state import load_row_state, save_row_state
    from llamacog_tpu_torch.utils.synthetic import (
        CODEBOOK_PRESETS, DEFAULT_LAYOUT, command_r7b_config, command_r_v01_config,
        deepseek_v2_config, deepseek_v2_lite_config, gemma2_9b_config, gemma3_4b_config,
        gemma3_12b_config, gemma_7b_config, llama3_70b_config, llama3_8b_config,
        make_synthetic_params, mixtral_8x7b_config, phi3_5_mini_config, qwen2_5_0_5b_config,
        qwen2_5_7b_config, qwen2_57b_a14b_config, qwen3_8b_config, qwen3_30b_a3b_config,
        random_experts, random_wire, falcon_7b_config, falcon_40b_config, gpt2_config,
        gptj_6b_config, phi2_config, pythia_6_9b_config, stablelm2_1_6b_config,
        llama3_2_1b_config,
        starcoder2_7b_config, starcoderbase_7b_config, llama4_scout_config,
        granite_3_1_8b_config, granite_3_1_3b_a800m_config, olmoe_1b_7b_config,
        olmo2_7b_config, olmo_7b_config, minicpm_2b_config, bloom_7b1_config, mpt_7b_config,
        jais_13b_config, refact_1_6b_config, xverse_7b_config, baichuan2_7b_config,
        internlm2_7b_config, exaone_3_7_8b_config, orion_14b_config, codeshell_7b_config,
        qwen_7b_config, plamo_13b_config, minitron_4b_config, afm_4_5b_config,
        deepseek_moe_16b_config, dots1_config, ling_lite_config, phi3_5_moe_config,
        grok_1_config, dbrx_config, arctic_config, minicpm3_4b_config, plm_1_8b_config,
        glm4_9b_0414_config, glm_4_9b_chat_config, chameleon_7b_config, chameleon_30b_config,
        bitnet_b1_58_large_config, openelm_3b_config, deci_51b_config)

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
    def weight_parity(kname, fn, B, label, ws, multi, run, listed=True):
        """qmv or qgemm at B rows of x over the weights ws (one launch),
        held against qmm_plain; the launches read from the phase-5 run `run`
        (with listed False, checked and logged only: no phase-5 run)."""
        K = ws[0].shape[1]
        x = torch.randn(B, K, generator=g, device=dev).to(torch.bfloat16)
        outs = fn(x, ws)
        refs = [qmm_plain(x, w) for w in ws]
        torch.cuda.synchronize()
        nbytes = sum(wire_need(w) for w in ws) + x.numel() * 2 + sum(o.numel() * 4 for o in outs)
        flops = sum(2 * B * w.shape[0] * w.shape[1] for w in ws)
        record(f"{kname} B={B} {label}", qmm_src.format(kname),
               multi_rep if multi else qmm_rep[kname],
               outs, refs, TOL_QMM,
               time_ms(lambda: fn(x, ws)), time_ms(lambda: [qmm_plain(x, w) for w in ws],
                                                  iters=5),
               nbytes, flops, run=run, listed=listed)

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
    # the LM head over several positions, speculative decoding's verify: the
    # on-device round's k + 1 = 5 rows (qmv) and the host-driven verify's
    # 32-row bucket (qgemm, Engine.prefill_logits); launches from the
    # phase-5 speculative runs
    weight_parity("qmv", qmv, 5, "output Q6_K 128256x4096", [w_head], False, "8b spec on device")
    weight_parity("qgemm", qgemm, 32, "output Q6_K 128256x4096", [w_head], False, "8b spec host")
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

    def gather_launches(S, run=None):
        """Where a K10 row at S rows over a Mixtral stack reads its launches:
        rows grouped by expert (qmm_id.gather_groups) count as qmv_id_group
        in the 8-row Mixtral run of phase 5, a block per row as qmv_id in
        `run` (by default the Mixtral run)."""
        if gather_groups(S, n_exp):
            return {"counter": "qmv_id_group", "run": MIXTRAL_BATCH_RUN}
        return {"counter": "qmv_id", "run": run}

    # one token's rows (a block per row), 16 tokens' (grouped), and the
    # 8-row Mixtral run's rows (8 tokens' top 2: grouped) on both stacks
    for label, w, tokens, fn, line in (
            ("qmv_id gather ffn_gate_up_exps Q4_K 8x28672x4096", moe_gu, 1, qmm_gather, 115),
            ("qmv_id gather ffn_gate_up_exps Q4_K 8x28672x4096", moe_gu, 8, qmm_gather, 115),
            ("qmv_id gather ffn_gate_up_exps Q4_K 8x28672x4096", moe_gu, 16, qmm_gather, 115),
            ("qmv_id gather ffn_down_exps Q6_K 8x4096x14336", moe_d6, 1, qmm_gather, 115),
            ("qmv_id gather ffn_down_exps Q6_K 8x4096x14336", moe_d6, 8, qmm_gather, 115),
            ("qmv_id gather ffn_down_exps Q6_K 8x4096x14336", moe_d6, 16, qmm_gather, 115),
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
               expert_bytes(w, ids) + x.numel() * 2 + out.numel() * 4, 2 * S_rows * Nw * Kw,
               **gather_launches(S_rows))
    # the gather's grouping by expert under skewed routing: 32 rows on one
    # expert (four passes of 8 over its bytes) and 32 on four, on both
    # stacks; launches from the 8-row Mixtral run of phase 5 (16 rows a
    # product, grouped)
    for (stem, w), (label, ids) in itertools.product(
            (("ffn_gate_up_exps Q4_K 8x28672x4096", moe_gu),
             ("ffn_down_exps Q6_K 8x4096x14336", moe_d6)),
            (("one expert", torch.full((32,), 5, dtype=torch.int32, device=dev)),
             ("four experts", torch.arange(32, dtype=torch.int32, device=dev) % 4 * 2))):
        (_, Nw, Kw) = w.shape
        x = torch.randn(32, Kw, generator=g, device=dev).to(torch.bfloat16)
        out, ref = qmm_gather(x, ids, w), qmm_gather_plain(x, ids, w)
        torch.cuda.synchronize()
        record(f"qmv_id gather {stem} S=32 {label}",
               qmm_src.format("qmv_id"), qid_rep.format(115), [out], [ref], TOL_QMM,
               time_ms(lambda: qmm_gather(x, ids, w)),
               time_ms(lambda: qmm_gather_plain(x, ids, w), iters=5),
               expert_bytes(w, ids) + x.numel() * 2 + out.numel() * 4,
               2 * 32 * Nw * Kw, **gather_launches(32))
    # a row's result does not depend on the rows beside it: each of 8 rows
    # alone (a pass of one row) against the same row in a 32-row launch
    ids = route(16)
    x = torch.randn(32, E, generator=g, device=dev).to(torch.bfloat16)
    full = qmm_gather(x, ids, moe_gu)
    worst = max(rel_err(qmm_gather(x[s:s + 1].contiguous(), ids[s:s + 1].contiguous(),
                                   moe_gu)[0], full[s]) for s in range(8))
    check(worst <= 1e-6, f"qmv_id: a row alone differs from the same row in a 32-row launch "
          f"by {worst:.3e} (relative)")
    log(f"[parity] qmv_id row independence: 8 rows alone against a 32-row launch over "
        f"{len(set(ids.tolist()))} experts, worst relative difference {worst:.3e} (limit 1e-6)")
    # the f32 ragged route (an f32 model's prefill): the gather kernel over a
    # 128-token prefill's expert-sorted, padded rows, a block per row; no
    # phase-5 run drives an f32 model (phase 4's f32 cases do)
    ids = route(PROMPT_LEN)
    dest, tile_expert, s_pad = moe_sort(ids, n_exp, RAGGED_TILE)
    rows = torch.randn(ids.shape[0], E, generator=g, device=dev)
    xs = torch.zeros(s_pad, E, device=dev).index_copy_(0, dest, rows)
    out = qmm_ragged(xs, tile_expert, moe_gu, RAGGED_TILE)
    ref = qmm_ragged_plain(xs, tile_expert, moe_gu, RAGGED_TILE)
    torch.cuda.synchronize()
    record(f"qmv_id ragged f32 ffn_gate_up_exps Q4_K 8x28672x4096 tokens={PROMPT_LEN} "
           f"s_pad={s_pad}", qmm_src.format("qmv_id"), qid_rep.format(188), [out], [ref],
           TOL_QMM, time_ms(lambda: qmm_ragged(xs, tile_expert, moe_gu, RAGGED_TILE)),
           time_ms(lambda: qmm_ragged_plain(xs, tile_expert, moe_gu, RAGGED_TILE), iters=5),
           expert_bytes(moe_gu, ids) + ids.shape[0] * (E * 4 + 2 * Fm * 4),
           2 * ids.shape[0] * 2 * Fm * E, peak=F32_FLOPS, listed=False)
    del full, xs, rows, out, ref
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
                       2 * ids.shape[0] * Nw * Kw, **gather_launches(ids.shape[0], run))
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

    # the Qwen and Gemma families' shapes, each read in its phase-5 run:
    # K1/K2 on Qwen2.5-0.5B's padded Q5_0 and Q8_0 rows (K = 896: qmv reads
    # x below K, qgemm takes x padded), K1/K3 at the families' projections,
    # K4/K5 at their heads (Gemma 16 over 8 at D 256 with softcap 50 and
    # window 4096, Qwen2.5 28 over 4, the 0.5B 14 over 2 at D 64), K6/K7 at
    # D 256, K10/K11 at Qwen3-30B-A3B's experts
    fam_ws = {
        "qwen2.5-0.5b": [("attn_qkv Q5_0 1152x896 (padded to 1024)", ["Q5_0"], [1152], 896),
                         ("attn_v Q8_0 128x896 (padded)", ["Q8_0"], [128], 896),
                         ("ffn_gate_up Q5_0 9728x896 (padded)", ["Q5_0"], [9728], 896),
                         ("output (tied token_embd) Q8_0 151936x896 (padded)", ["Q8_0"],
                          [151936], 896)],
        "qwen2.5-7b": [("attn_q Q4_K 3584x3584 (biased: its own launch)", ["Q4_K"], [3584],
                        3584),
                       ("ffn_gate_up Q4_K 37888x3584", ["Q4_K"], [37888], 3584)],
        "qwen3-8b": [("attn_q+attn_k+attn_v Q4_K 4096x4096 + Q4_K 1024x4096 + Q6_K 1024x4096",
                      ["Q4_K", "Q4_K", "Q6_K"], [4096, 1024, 1024], 4096)],
        "qwen3-30b-a3b": [("attn_q+attn_k+attn_v Q4_K 4096x2048 + Q4_K 512x2048 + Q6_K "
                           "512x2048", ["Q4_K", "Q4_K", "Q6_K"], [4096, 512, 512], 2048)],
        "gemma3-12b": [("ffn_gate_up Q4_K 30720x3840", ["Q4_K"], [30720], 3840),
                       ("output (tied token_embd) Q6_K 262208x3840", ["Q6_K"], [262208],
                        3840)],
        # MLA: q and the compressed kv in one launch, the decompression at K
        # 512; the dense lead layer's gate_up and its ffn_down at K 10944
        # (Q6_K's 32-block fallback Q8_0: layer 0 takes more bits); the two
        # shared experts' gate and up in one launch
        "deepseek-v2-lite": [
            ("attn_q+attn_kv_a_mqa Q4_K 3072x2048 + Q4_K 576x2048", ["Q4_K", "Q4_K"],
             [3072, 576], 2048),
            ("attn_kv_b Q4_K 4096x512", ["Q4_K"], [4096], 512),
            ("ffn_gate_up (dense layer 0) Q4_K 21888x2048", ["Q4_K"], [21888], 2048),
            ("ffn_down (dense layer 0) Q8_0 2048x10944 (padded to 11008)", ["Q8_0"], [2048],
             10944),
            ("ffn_gate_shexp+ffn_up_shexp Q4_K 2816x2048 x2", ["Q4_K", "Q4_K"], [2816, 2816],
             2048)],
        # the q LoRA: attn_q_a with the compressed kv, then attn_q_b at K 1536
        "deepseek-v2": [
            ("attn_q_a+attn_kv_a_mqa Q4_K 1536x5120 + Q4_K 576x5120", ["Q4_K", "Q4_K"],
             [1536, 576], 5120),
            ("attn_q_b Q4_K 24576x1536", ["Q4_K"], [24576], 1536),
            ("attn_kv_b Q4_K 32768x512", ["Q4_K"], [32768], 512)],
        "phi3.5-mini": [("attn_qkv Q5_K 9216x3072", ["Q5_K"], [9216], 3072),
                        ("ffn_gate_up Q4_K 16384x3072", ["Q4_K"], [16384], 3072)],
        "command-r-v01": [("attn_qkv Q4_K 24576x8192", ["Q4_K"], [24576], 8192),
                          ("ffn_gate_up Q4_K 45056x8192", ["Q4_K"], [45056], 8192),
                          ("output (tied token_embd) Q6_K 256000x8192", ["Q6_K"], [256000],
                           8192)],
        "gemma-7b": [("attn_qkv Q4_K 12288x3072", ["Q4_K"], [12288], 3072)],
        # the layer-norm families: Falcon-7B's K-4544 rows in their 32-weight-
        # block fallback kinds (padded to 4608) and its K-quant ffn_down at K
        # 18176; Phi-2's biased attn_qkv (its own launch); GPT-J's q+k with
        # Q6_K v in one launch
        "falcon-7b": [("attn_qkv Q5_1 4672x4544 (padded to 4608)", ["Q5_1"], [4672], 4544),
                      ("ffn_up Q5_0 18176x4544 (padded)", ["Q5_0"], [18176], 4544),
                      ("ffn_down Q6_K 4544x18176", ["Q6_K"], [4544], 18176)],
        "phi2": [("attn_qkv Q5_K 7680x2560 (biased)", ["Q5_K"], [7680], 2560)],
        "gpt-j-6b": [("attn_qk+attn_v Q4_K 8192x4096 + Q6_K 4096x4096", ["Q4_K", "Q6_K"],
                      [8192, 4096], 4096)],
        # Llama 4 and the OLMo and scaled families: Llama-4-Scout's q+k with
        # a more-bits layer's Q6_K v over K 5120 and its 202048-row head;
        # Granite-3.1-8B's gate_up and tied head; OLMo-2's and OLMoE's q, k
        # and v apart in one launch (their whole-projection q/k norms keep
        # q and k unfused)
        "llama4-scout": [("attn_qk+attn_v Q4_K 6144x5120 + Q6_K 1024x5120", ["Q4_K", "Q6_K"],
                          [6144, 1024], 5120),
                         ("output Q6_K 202048x5120", ["Q6_K"], [202048], 5120)],
        "granite-3.1-8b": [("ffn_gate_up Q4_K 25600x4096", ["Q4_K"], [25600], 4096),
                           ("output (tied token_embd) Q6_K 49155x4096", ["Q6_K"], [49155],
                            4096)],
        "olmo2-7b": [("attn_q+attn_k+attn_v Q4_K 4096x4096 x2 + Q6_K 4096x4096",
                      ["Q4_K", "Q4_K", "Q6_K"], [4096, 4096, 4096], 4096)],
        "olmoe-1b-7b": [("attn_q+attn_k+attn_v Q4_K 2048x2048 x2 + Q6_K 2048x2048",
                         ["Q4_K", "Q4_K", "Q6_K"], [2048, 2048, 2048], 2048)],
        # the ALiBi families, the clones and relu^2: BLOOM-7B1's tied
        # 250880-row head and biased Q5_K attn_qkv; Jais-13B's biased gate
        # of 13653 rows (its own launch); Qwen-7B's gate_up of 2 x 11008
        # rows (its tensors' width, half its feed_forward_length)
        "bloom-7b1": [("output (tied token_embd) Q6_K 250880x4096", ["Q6_K"], [250880], 4096),
                      ("attn_qkv Q5_K 12288x4096 (biased)", ["Q5_K"], [12288], 4096)],
        "jais-13b": [("ffn_gate Q4_K 13653x5120 (biased)", ["Q4_K"], [13653], 5120)],
        "qwen-7b": [("ffn_gate_up Q4_K 22016x4096", ["Q4_K"], [22016], 4096)],
        # the MoE variants: dots.llm1's 152064-row head and Grok-1's tied
        # 131072-row one (Q6_K); DBRX's fused attn_qkv (Q5_K, 64 heads of 128
        # over K 6144)
        "dots1": [("output Q6_K 152064x4096", ["Q6_K"], [152064], 4096)],
        "grok-1": [("output (tied token_embd) Q6_K 131072x6144", ["Q6_K"], [131072], 6144)],
        "dbrx": [("attn_qkv Q5_K 8192x6144", ["Q5_K"], [8192], 6144)],
        # the last decoders: GLM-4-9B-0414's fused gate_up (its lone ffn_up of
        # 2 x 13696 rows) and its ffn_down at K 13696 in Q4_K's 32-block
        # fallback; MiniCPM3-4B's q LoRA with the compressed kv in one
        # launch and its q decompression at K 768; BitNet b1.58-large's
        # ternary rows (K 1536 and 4096: whole 256-weight blocks) in TQ2_0
        # and TQ1_0, each product its own launch (its scales keep them apart)
        "glm4-9b-0414": [("ffn_gate_up Q4_K 27392x4096", ["Q4_K"], [27392], 4096),
                         ("ffn_down Q5_0 4096x13696 (padded to 13824)", ["Q5_0"], [4096],
                          13696)],
        "minicpm3-4b": [("attn_q_a+attn_kv_a_mqa Q4_K 768x2560 + Q4_K 288x2560",
                         ["Q4_K", "Q4_K"], [768, 288], 2560),
                        ("attn_q_b Q4_K 3840x768", ["Q4_K"], [3840], 768)],
        **{f"bitnet {tq}": [(f"ffn_gate {tq} 4096x1536", [tq], [4096], 1536),
                            (f"ffn_down {tq} 1536x4096", [tq], [1536], 4096),
                            (f"attn_q {tq} 1536x1536", [tq], [1536], 1536)]
           for tq in ("TQ2_0", "TQ1_0")},
    }
    for run, items in fam_ws.items():
        for label, kinds, rows, Kw in items:
            ws = [random_wire(kd, n, Kw, g, dev) for kd, n in zip(kinds, rows)]
            for kname, fn, B in (("qmv", qmv, 1), ("qgemm", qgemm, PROMPT_LEN)):
                if kname == "qgemm" and label.startswith("output"):
                    continue  # the LM head runs on the last position only
                weight_parity(kname, fn, B, f"{run} {label}", ws, len(ws) > 1, run)
            if run == "qwen2.5-0.5b":
                # 4 rows, a 4-slot server's decode step: the K tail of the
                # walk where a lane holds several rows of x (no phase-5 run)
                weight_parity("qmv", qmv, 4, f"{run} {label}", ws, False, run, listed=False)
            del ws
        torch.cuda.empty_cache()
    def fam_attention(run, H_, Hkv_, D_, softcap, window, quant_run=None, Dv_=None,
                      deep=False, offsets=(0,)):
        """K4 at depth 1000 (and, with a window, 5000 of 8192, where the
        window bites; with deep, 32765 of 32768) and K5 over a 128-token
        prompt from each write offset of `offsets` (of 1024 slots) at these
        heads (key dim D_, value dim Dv_, D_ by default), with SDPA beside
        them where there is no softcap (SDPA has none); with quant_run, K6
        (at depth 1000, and with deep 32765) and K7 over q8_0 planes of the
        same heads, K7 from offsets 0 and 896."""
        Dv_ = Dv_ or D_
        check(window == 0 or offsets == (0,), "fam_attention: K5 from an offset without a "
              "window only")
        sc = D_ ** -0.5
        kw = dict(softcap=softcap, window=window)
        shape = (f"H={H_} Hkv={Hkv_} " + (f"Dk={D_} Dv={Dv_}" if Dv_ != D_ else f"D={D_}")
                 + (f" softcap={softcap:g}" if softcap else "")
                 + (f" window={window}" if window else ""))
        q1, kc1, vc1 = rnd(1, H_, D_), rnd(1, Hkv_, D_), rnd(1, Hkv_, Dv_)
        for S_dec, n in ((1024, 1000), *([(8192, 5000)] if window else []),
                         *([(32768, 32765)] if deep else [])):
            ks, vs = rnd(2, 1, S_dec, Hkv_, D_), rnd(2, 1, S_dec, Hkv_, Dv_)
            seq = torch.tensor([n], dtype=torch.int32, device=dev)
            args = (q1, ks, vs, 1, kc1, vc1, seq, sc)
            out = no_sync(lambda: flash_decode_stacked_dense(*args, **kw))
            ref = flash_decode_stacked_dense_plain(*args, **kw)
            lo = max(0, n - window + 1) if window else 0  # the first old slot attended
            lib_ms = None
            if not softcap:
                kf = torch.cat([ks[1, :, lo:n], kc1[:, None]], 1).transpose(1, 2).contiguous()
                vf = torch.cat([vs[1, :, lo:n], vc1[:, None]], 1).transpose(1, 2).contiguous()
                lib_ms = time_ms(lambda: sdpa(q1[:, :, None], kf, vf, scale=sc,
                                              enable_gqa=True))
            torch.cuda.synchronize()
            record(f"flash_decode_dense {shape} S={S_dec} seq_len={n}",
                   "llamacog_tpu_torch/csrc/flash_decode_dense.cu",
                   "llamacog_tpu/ops/pallas/flash_q8.py:968", [out], [ref], TOL_ATTN,
                   time_ms(lambda: flash_decode_stacked_dense(*args, **kw)),
                   time_ms(lambda: flash_decode_stacked_dense_plain(*args, **kw), iters=5),
                   2 * (q1.numel() + (n - lo) * Hkv_ * (D_ + Dv_) + kc1.numel() + vc1.numel()
                        + H_ * Dv_), 2 * H_ * (n - lo + 1) * (D_ + Dv_), lib_ms, run=run)
            del ks, vs
        T_ = PROMPT_LEN
        qp1, kcp1, vcp1 = rnd(1, T_, H_, D_), rnd(1, T_, Hkv_, D_), rnd(1, T_, Hkv_, Dv_)
        kl1, vl1 = rnd(1, 1024, Hkv_, D_), rnd(1, 1024, Hkv_, Dv_)
        for n in offsets:
            seq = torch.tensor([n], dtype=torch.int32, device=dev)
            args = (qp1, kl1, vl1, kcp1, vcp1, seq, sc)
            before = dict(build.LAUNCHES)
            out = no_sync(lambda: flash_prefill_kernel(*args, **kw))
            took = {k: c - before[k] for k, c in build.LAUNCHES.items() if c != before[k]}
            check(took == {"flash_prefill": 1}, f"K5 {shape}: launched {took}, not the tiles")
            ref = flash_prefill_attention_plain(*args, **kw)
            ti = torch.arange(T_, device=dev)
            # the old positions, then the causal (windowed) current block
            allowed = torch.cat([torch.ones(T_, n, dtype=torch.bool, device=dev),
                                 (ti[None, :] <= ti[:, None])
                                 & ((ti[None, :] > ti[:, None] - window) if window else True)],
                                dim=1)
            lib_ms = None
            if not softcap:
                qs1 = qp1.transpose(1, 2)
                kf = torch.cat([kl1[:, :n], kcp1], 1).transpose(1, 2).contiguous()
                vf = torch.cat([vl1[:, :n], vcp1], 1).transpose(1, 2).contiguous()
                lib_ms = time_ms(lambda: sdpa(qs1, kf, vf, attn_mask=allowed, scale=sc,
                                              enable_gqa=True))
            torch.cuda.synchronize()
            keys = int(allowed.sum())
            record(f"flash_prefill T={T_} {shape} S=1024 seq_len={n}",
                   "llamacog_tpu_torch/csrc/flash_prefill.cu",
                   "llamacog_tpu/ops/pallas/flash_prefill.py:129", [out], [ref], TOL_ATTN,
                   time_ms(lambda: flash_prefill_kernel(*args, **kw)),
                   time_ms(lambda: flash_prefill_attention_plain(*args, **kw), iters=5),
                   2 * (qp1.numel() + n * Hkv_ * (D_ + Dv_) + kcp1.numel() + vcp1.numel()
                        + T_ * H_ * Dv_), 2 * H_ * keys * (D_ + Dv_), lib_ms, run=run)
        if quant_run is None:
            return
        kinds = ("q8_0", "q8_0")

        def q8_cache(S_q):
            cq = QuantKVCache.create(2, 1, S_q, Hkv_, D_, Dv_, kinds=kinds, device=dev)
            for il in range(2):
                part = QuantKVCache([p[il:il + 1] for p in cq.k_planes],
                                    [p[il:il + 1] for p in cq.v_planes], kinds, Hkv_)
                part.write_all(torch.randn(1, 1, S_q, Hkv_, D_, generator=g, device=dev),
                               torch.randn(1, 1, S_q, Hkv_, Dv_, generator=g, device=dev),
                               torch.zeros(1, dtype=torch.int32, device=dev))
            return cq

        # a head's K and V rows: int8 values, an f32 scale a 32-value group
        plane_row = D_ + 4 * (D_ // 32) + Dv_ + 4 * (Dv_ // 32)
        for S_q, n in ((1024, 1000), *([(32768, 32765)] if deep else [])):
            cache = q8_cache(S_q)
            if S_q == 1024:
                cq = cache  # K7's planes below
            seq = torch.tensor([n], dtype=torch.int32, device=dev)
            args = (q1, cache.k_planes, cache.v_planes, 1, kc1, vc1, seq, sc)
            out = no_sync(lambda: flash_decode_stacked(*args, kinds=kinds, **kw))
            ref = flash_decode_stacked_plain(*args, kinds=kinds, **kw)
            torch.cuda.synchronize()
            record(f"flash_decode_stacked q8_0:q8_0 {shape} S={S_q} seq_len={n}",
                   "llamacog_tpu_torch/csrc/flash_decode_quant.cu", fq8.format(828), [out],
                   [ref], TOL_ATTN,
                   time_ms(lambda: flash_decode_stacked(*args, kinds=kinds, **kw)),
                   time_ms(lambda: flash_decode_stacked_plain(*args, kinds=kinds, **kw),
                           iters=5),
                   n * Hkv_ * plane_row + 2 * (q1.numel() + kc1.numel() + vc1.numel()
                                               + H_ * Dv_),
                   2 * H_ * (n + 1) * (D_ + Dv_), run=quant_run)
            del cache
        kp, vp = [p[1] for p in cq.k_planes], [p[1] for p in cq.v_planes]
        for n in (0, 1024 - T_):
            seq = torch.tensor([n], dtype=torch.int32, device=dev)
            args = (qp1, kp, vp, kcp1, vcp1, seq, sc)
            before = dict(build.LAUNCHES)
            out = no_sync(lambda: flash_prefill_q8(*args, kinds=kinds, **kw))
            took = {k: c - before[k] for k, c in build.LAUNCHES.items() if c != before[k]}
            check(took == {"flash_prefill_quant": 1},
                  f"K7 {shape} n={n}: launched {took}, not the tiles")
            ref = flash_prefill_q8_plain(*args, kinds=kinds, **kw)
            torch.cuda.synchronize()
            keys = sum(n + t + 1 for t in range(T_))
            record(f"flash_prefill_q8 q8_0:q8_0 T={T_} {shape} S=1024 seq_len={n}",
                   "llamacog_tpu_torch/csrc/flash_prefill_quant.cu", fq8.format(331), [out],
                   [ref], TOL_ATTN, time_ms(lambda: flash_prefill_q8(*args, kinds=kinds, **kw)),
                   time_ms(lambda: flash_prefill_q8_plain(*args, kinds=kinds, **kw), iters=5),
                   n * Hkv_ * plane_row + 2 * (qp1.numel() + kcp1.numel() + vcp1.numel()
                                               + T_ * H_ * Dv_), 2 * H_ * keys * (D_ + Dv_),
                   run=quant_run)
        del cq, kp, vp

    fam_attention("gemma2-9b", 16, 8, 256, 50.0, 0)  # the ring's global layers
    fam_attention("gemma2-9b kv bf16", 16, 8, 256, 50.0, 4096, quant_run="gemma2-9b kv q8_0")
    fam_attention("qwen2.5-7b", 28, 4, 128, 0.0, 0)
    fam_attention("qwen2.5-0.5b", 14, 2, 64, 0.0, 0)
    # Llama-3-70B's heads (64 query heads over 8 kv heads: 8 a kv head,
    # where the 8B has 4), read in the 70B run of phase 5
    fam_attention("70b IQ2_XXS", llama3_70b_config().n_head, Hkv, D, 0.0, 0)
    # DeepSeek-V2's MLA heads: K 192 (128 nope + 64 rope), V 128, one kv head
    # a query head (K5/K7's 192/128 tiles); Phi-3.5's D 96; Command-R's and
    # Gemma-7B's MHA
    fam_attention("deepseek-v2-lite", 16, 16, 192, 0.0, 0, quant_run="deepseek-v2-lite kv q8_0",
                  Dv_=128)
    fam_attention("deepseek-v2", 128, 128, 192, 0.0, 0, Dv_=128)
    fam_attention("phi3.5-mini", 32, 32, 96, 0.0, 0, quant_run="phi3.5-mini kv q8_0")
    fam_attention("command-r-v01", 64, 64, 128, 0.0, 0)
    fam_attention("gemma-7b", 16, 16, 256, 0.0, 0)
    # multi-query heads, K4/K6 in head groups of 8 past 16 query heads a kv
    # head: Falcon-7B's 71 over one kv head of 64, StarCoder-15B's 48 and
    # StarCoderBase-7B's 32 over one of 128, at depths 1000 and 32765, K5
    # (and K7) from offsets 0 and 896; the 48-head rows read their launches
    # in the StarCoderBase-7B runs (no run drives StarCoder-15B); Phi-2's D
    # 80 (K4/K5 only: a quantized cache at D 80 takes the masked path)
    fam_attention("falcon-7b", 71, 1, 64, 0.0, 0, quant_run="falcon-7b kv q8_0", deep=True,
                  offsets=(0, 896))
    fam_attention("starcoderbase-7b", 48, 1, 128, 0.0, 0,
                  quant_run="starcoderbase-7b kv q8_0", deep=True)
    fam_attention("starcoderbase-7b", 32, 1, 128, 0.0, 0,
                  quant_run="starcoderbase-7b kv q8_0", deep=True)
    fam_attention("phi2", 32, 32, 80, 0.0, 0)
    # PLaMo-13B's 40 query heads over 5 kv heads (8 a kv head at D 128)
    fam_attention("plamo-13b", 40, 5, 128, 0.0, 0)
    # the MoE variants' heads: Grok-1's 48 over 8 with the softcap 30 after
    # its fixed scale 1/sqrt(128) (scale, then softcap, as Gemma-2's; no
    # SDPA beside it: SDPA has no softcap), Snowflake Arctic's 56 over 8
    fam_attention("grok-1", 48, 8, 128, 30.0, 0)
    fam_attention("arctic", 56, 8, 128, 0.0, 0)
    # the last decoders' heads: MiniCPM3-4B's MLA at K 96 (64 nope + 32
    # rope) / V 64, one kv head a query head (K5/K7's 96/64 tiles), dense
    # and q8_0; GLM-4-9B-0414's 32 query heads over 2 (16 a kv head, one
    # head group of K4)
    fam_attention("minicpm3-4b", 40, 40, 96, 0.0, 0, quant_run="minicpm3-4b kv q8_0", Dv_=64)
    fam_attention("glm4-9b-0414", 32, 2, 128, 0.0, 0)
    torch.cuda.empty_cache()

    def family_experts(run, n_exp_f, top_k, stacks, run512=None):
        """K10 (the gather at one token's and four tokens' rows) and K11 (the
        grouped GEMM of a 128-token prefill, and with run512 a 512-token
        one) over each (label, stack) of a family's experts, top_k of
        n_exp_f routed from random logits; the launches from the phase-5
        run `run`. A padded stack's bound counts its real blocks."""
        def fam_route(tokens):
            logits = torch.randn(tokens, n_exp_f, generator=g, device=dev)
            return torch.topk(logits, top_k, dim=-1).indices.reshape(-1).to(torch.int32)

        for label, w in stacks:
            _, Nw, Kw = w.shape
            per_expert = wire_need(w) // n_exp_f
            for tokens in (1, 4):
                ids = fam_route(tokens)
                x = torch.randn(ids.shape[0], Kw, generator=g, device=dev).to(torch.bfloat16)
                out = no_sync(lambda: qmm_gather(x, ids, w))
                ref = qmm_gather_plain(x, ids, w)
                torch.cuda.synchronize()
                record(f"qmv_id gather {label} S={ids.shape[0]}", qmm_src.format("qmv_id"),
                       qid_rep.format(115), [out], [ref], TOL_QMM,
                       time_ms(lambda: qmm_gather(x, ids, w)),
                       time_ms(lambda: qmm_gather_plain(x, ids, w), iters=5),
                       per_expert * len(set(ids.tolist())) + x.numel() * 2 + out.numel() * 4,
                       2 * ids.shape[0] * Nw * Kw, run=run)
            for tokens, r in ((PROMPT_LEN, run), *([(512, run512)] if run512 else [])):
                ids = fam_route(tokens)
                dest, tile_expert, s_pad = moe_sort(ids, n_exp_f, RAGGED_TILE)
                rows = torch.randn(ids.shape[0], Kw, generator=g, device=dev).to(torch.bfloat16)
                xs = torch.zeros(s_pad, Kw, dtype=torch.bfloat16, device=dev).index_copy_(
                    0, dest, rows)
                out = qmm_ragged(xs, tile_expert, w, RAGGED_TILE)
                ref = qmm_ragged_plain(xs, tile_expert, w, RAGGED_TILE)
                torch.cuda.synchronize()
                record(f"qgemm_id ragged {label} tokens={tokens} rows={ids.shape[0]} "
                       f"s_pad={s_pad}", qmm_src.format("qgemm_id"), qid_rep.format(188),
                       [out], [ref], TOL_QMM,
                       time_ms(lambda: qmm_ragged(xs, tile_expert, w, RAGGED_TILE)),
                       time_ms(lambda: qmm_ragged_plain(xs, tile_expert, w, RAGGED_TILE),
                               iters=5),
                       per_expert * len(set(ids.tolist())) + ids.shape[0] * (Kw * 2 + Nw * 4),
                       2 * ids.shape[0] * Nw * Kw, run=r)
                del xs, rows, out, ref
        torch.cuda.empty_cache()

    # Qwen3-30B-A3B's experts (128, top 8): gate_up 128x1536x2048 (Q4_K) and
    # down 128x2048x768 (Q6_K, a more-bits layer's); DeepSeek-V2-Lite's (64,
    # top 6): gate_up 64x2816x2048 and down 64x2048x1408, whose K 256 does
    # not divide (Q4_K's fallback Q5_0, and Q8_0, Q6_K's, on the more-bits
    # layers: rows padded with zero blocks to 1536); DeepSeek-V2's (160, top
    # 6): gate_up 160x3072x5120 and down 160x5120x1536
    q3 = qwen3_30b_a3b_config()
    family_experts("qwen3-30b-a3b", q3.n_expert, q3.n_expert_used, [
        ("ffn_gate_up_exps Q4_K 128x1536x2048",
         random_experts("Q4_K", q3.n_expert, 2 * q3.n_ff_exp, q3.n_embd, g, dev)),
        ("ffn_down_exps Q6_K 128x2048x768",
         random_experts("Q6_K", q3.n_expert, q3.n_embd, q3.n_ff_exp, g, dev))],
        run512="qwen3-30b-a3b 512")
    dl = deepseek_v2_lite_config()
    family_experts("deepseek-v2-lite", dl.n_expert, dl.n_expert_used, [
        ("ffn_gate_up_exps Q4_K 64x2816x2048",
         random_experts("Q4_K", dl.n_expert, 2 * dl.n_ff_exp, dl.n_embd, g, dev)),
        *((f"ffn_down_exps {kd} 64x2048x1408 (padded to 1536)",
           random_experts(kd, dl.n_expert, dl.n_embd, dl.n_ff_exp, g, dev))
          for kd in ("Q5_0", "Q8_0"))], run512="deepseek-v2-lite 512")
    dv2 = deepseek_v2_config()
    family_experts("deepseek-v2", dv2.n_expert, dv2.n_expert_used, [
        ("ffn_gate_up_exps Q4_K 160x3072x5120",
         random_experts("Q4_K", dv2.n_expert, 2 * dv2.n_ff_exp, dv2.n_embd, g, dev)),
        ("ffn_down_exps Q4_K 160x5120x1536",
         random_experts("Q4_K", dv2.n_expert, dv2.n_embd, dv2.n_ff_exp, g, dev))])
    # Llama-4-Scout's experts (16, top 1: one pair a token, S = 1 at decode;
    # 128 rows in a 128-token prefill): gate_up 16x16384x5120 (Q4_K) and down
    # 16x5120x8192 (Q6_K, a more-bits layer's); OLMoE-1B-7B's (64, top 8):
    # 64x2048x2048 and 64x2048x1024; Granite-3.1-3B-A800M's (40, top 8):
    # 40x1024x1536 and 40x1536x512
    for run, cfgx in (("llama4-scout", llama4_scout_config()),
                      ("olmoe-1b-7b", olmoe_1b_7b_config()),
                      ("granite-3.1-3b-a800m", granite_3_1_3b_a800m_config())):
        n_x, f_x, e_x = cfgx.n_expert, cfgx.n_ff_exp, cfgx.n_embd
        family_experts(run, n_x, cfgx.n_expert_used, [
            (f"ffn_gate_up_exps Q4_K {n_x}x{2 * f_x}x{e_x}",
             random_experts("Q4_K", n_x, 2 * f_x, e_x, g, dev)),
            (f"ffn_down_exps Q6_K {n_x}x{e_x}x{f_x}",
             random_experts("Q6_K", n_x, e_x, f_x, g, dev))])
    # the MoE variants' experts at their published widths: Snowflake
    # Arctic's 128 (top 2) of 4864 over 7168, DBRX's 16 (top 4) of 10752
    # over 6144 and Grok-1's 8 (top 2) of 32768 over 6144, whose down has K
    # 32768: gate_up in Q4_K, down in Q6_K (a more-bits layer's); and
    # dots.llm1's 128 (top 6) of 1408 over 4096, its down at K 1408 padded
    # to 1536 (Q5_0, and Q8_0 on the more-bits layers, as DeepSeek-V2-Lite's)
    for run, cfgx in (("arctic", arctic_config()), ("dbrx", dbrx_config()),
                      ("grok-1", grok_1_config())):
        n_x, f_x, e_x = cfgx.n_expert, cfgx.n_ff_exp or cfgx.n_ff, cfgx.n_embd
        family_experts(run, n_x, cfgx.n_expert_used, [
            (f"ffn_gate_up_exps Q4_K {n_x}x{2 * f_x}x{e_x}",
             random_experts("Q4_K", n_x, 2 * f_x, e_x, g, dev)),
            (f"ffn_down_exps Q6_K {n_x}x{e_x}x{f_x}",
             random_experts("Q6_K", n_x, e_x, f_x, g, dev))])
    d1 = dots1_config()
    family_experts("dots1", d1.n_expert, d1.n_expert_used, [
        ("ffn_gate_up_exps Q4_K 128x2816x4096",
         random_experts("Q4_K", d1.n_expert, 2 * d1.n_ff_exp, d1.n_embd, g, dev)),
        *((f"ffn_down_exps {kd} 128x4096x1408 (padded to 1536)",
           random_experts(kd, d1.n_expert, d1.n_embd, d1.n_ff_exp, g, dev))
          for kd in ("Q5_0", "Q8_0"))])

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

    # the host memory of the plain copies' decoded weights, one buffer that
    # grows and is reused by each two_copies call: a copy into fresh
    # pageable memory spends most of its time faulting its pages in (~2 GB/s)
    host_pool = [torch.empty(0, dtype=torch.uint8)]

    def two_copies(cfgp, ftype=DEFAULT_LAYOUT):
        """The synthetic params on the card, and a copy on the CPU for the
        plain path whose wire weights keep their plain dequant
        (wire.keep_decoded): the plain path's products read the same f32
        weights each step instead of decoding them again, most of its time
        otherwise (4 bytes a weight: a 2-layer Mixtral-wide copy holds its
        expert stacks in ~11 GB of host memory). The dequant runs on the
        card, the same torch ops as on the CPU, and is copied over (decoding
        the copies on the host took ~45% of phase 4) into views of
        host_pool, so the previous call's copy must be freed first; a sample
        of each weight's rows (every expert's first and last, and 32 drawn
        from the whole weight) is decoded on the CPU too and must be
        bit-equal. An untied embedding table keeps no decode: the lookup
        decodes its rows."""
        p_gpu = make_synthetic_params(cfgp, seed=7, ftype=ftype,
                                      imatrix=ftype in CODEBOOK_PRESETS)
        draw = torch.Generator().manual_seed(7)
        untied_embd = "output" in p_gpu
        kept = [v for k, v in p_gpu.items() if k != "layers" and isinstance(v, WireTensor)
                and not (k == "tok_embd" and untied_embd)]
        kept += [v for layer in p_gpu["layers"] for v in layer.values()
                 if isinstance(v, WireTensor)]
        need = sum(4 * math.prod(w.shape) for w in kept)
        if host_pool[0].numel() < need:
            host_pool[0] = torch.empty(0, dtype=torch.uint8)  # the old pages go first
            host_pool[0] = torch.empty(need, dtype=torch.uint8)
        used = [0]

        def to_host(t):
            n = 4 * t.numel()
            out = host_pool[0][used[0]:used[0] + n].view(torch.float32).view(t.shape)
            used[0] += n
            return out.copy_(t)

        def on_cpu(v):
            if not isinstance(v, WireTensor):
                return v.to("cpu")
            w, decoded = v.to("cpu"), to_host(dequantize(v))
            n_rows, n, k = w.blocks.shape[0], w.shape[-2], w.shape[-1]
            firsts = torch.arange(0, n_rows, n)  # one a stack's expert
            idx = torch.cat([firsts, firsts + n - 1,
                             torch.randint(n_rows, (32,), generator=draw)]).unique()
            rows = dequantize(WireTensor(w.kind, (len(idx), k), w.blocks.index_select(0, idx)))
            check(torch.equal(rows, decoded.reshape(-1, k).index_select(0, idx)),
                  f"{w.kind} {tuple(w.shape)}: the plain dequant on the card is not the CPU's")
            return WireTensor(w.kind, w.shape, w.blocks, w.qi8, w.ws8T, decoded)
        t_copy = time.perf_counter()
        # an untied embedding table is only gathered by row, which decodes
        # the looked-up rows' blocks (wire.dequantize_rows): no kept decode
        p_cpu = {k: (v if k == "layers" else v.to("cpu")
                     if k == "tok_embd" and untied_embd else on_cpu(v))
                 for k, v in p_gpu.items()}
        p_cpu["layers"] = [{k: on_cpu(v) for k, v in layer.items()} for layer in p_gpu["layers"]]
        log(f"[path] {cfgp.arch} {cfgp.n_layer} layers, {ftype}: the CPU copy in "
            f"{time.perf_counter() - t_copy:.1f}s")
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
        # one router call a MoE layer: deepseek2's leading dense layers have none
        k, n_l = cfgp.n_expert_used, cfgp.n_layer - cfgp.n_layer_dense_lead
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
        plain path's own gate probabilities (softmax, or sigmoid). Every real row (the first
        real_rows[step] rows; the rest are the prompt bucket's padding)
        whose experts differ from the plain path's own top-k is appended to
        `diffs` with whether it is a tie swap: the kernel path took the
        plain path's (k+1)-th expert for its k-th, and the two logits lie
        within TIE_ULPS bf16 ulps (with dots1's selection bias, the two
        scores within TIE_ULPS of the k-th logit's bf16 ulp times the
        sigmoid's slope there). Yields the function that ends a step."""
        if not cfgp.n_expert:
            yield lambda: None
            return
        k, step, calls = cfgp.n_expert_used, [0], [0]
        n_l = cfgp.n_layer - cfgp.n_layer_dense_lead
        orig = llama_mod._moe_router

        def route_as_kernel(layer, x, cfg):
            logits = qmatmul(x, layer["ffn_gate_inp"]).float()
            il = calls[0] % n_l
            calls[0] += 1
            ids, used = seen[step[0]]
            n_exp = logits.shape[-1]
            n_rows = logits.reshape(-1, n_exp).shape[0]
            check(int(used[il]) == n_rows, f"layer {il} step {step[0]}: the plain path routes "
                  f"{n_rows} rows, the kernel path routed {int(used[il])}")
            top_i = ids[il, :n_rows].reshape(*logits.shape[:-1], k)
            probs = (torch.sigmoid(logits) if cfg.expert_gating_func == "sigmoid"
                     else torch.softmax(logits, dim=-1))
            gate_w = torch.gather(probs, -1, top_i)
            if cfg.expert_weights_norm:
                gate_w = gate_w / (gate_w.sum(dim=-1, keepdim=True) + 1e-20)
            real = real_rows[step[0]]
            # the selection scores: the logits (softmax, or llama4's sigmoid:
            # either keeps their order), or dots1's sigmoid probabilities
            # plus its selection bias, which a logit's one ulp moves by the
            # sigmoid's slope times that ulp
            if "exp_probs_b" in layer:
                check(cfg.expert_gating_func == "sigmoid",
                      "the forced router takes a selection bias under sigmoid gating only")
                scores, slope = probs + layer["exp_probs_b"].float(), probs * (1 - probs)
            else:
                scores, slope = logits, torch.ones_like(logits)
            l2d, sl2d = logits.reshape(-1, n_exp)[:real], slope.reshape(-1, n_exp)[:real]
            own_l, own_i = torch.topk(scores.reshape(-1, n_exp)[:real], k + 1, dim=-1)
            got = top_i.reshape(-1, k)[:real].sort(dim=1).values
            for r in torch.nonzero((own_i[:, :k].sort(dim=1).values != got).any(dim=1)).flatten():
                r = int(r)
                swap = torch.cat([own_i[r, : k - 1], own_i[r, k:]]).sort().values
                hi, lo = float(own_l[r, k - 1]), float(own_l[r, k])
                kth = int(own_i[r, k - 1])
                ulp = (2.0 ** (torch.frexp(l2d[r, kth]).exponent.item() - 8)
                       * float(sl2d[r, kth]))
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
        within TOL_PATH at every step; a bf16 model launches no SIMT body of
        K5/K7. On a MoE model the router's bf16
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
                    # a ring's sliding-window layers read their ring through the
                    # masked attention, not a T=1 route
                    n_routed = sum(1 for il in range(cfgp.n_layer)
                                   if not (eng.ring and cfgp.is_swa(il)))
                    del eng
                    if name == "kernel":
                        log(f"[path] {model}, {label}: kernel launches "
                            f"{json.dumps({k: v for k, v in build.LAUNCHES.items() if v})}, "
                            f"T=1 attention calls {json.dumps(calls)}, decode graphs "
                            f"(kv_cap: captured launches) {graphs}")
                        missing = [k for k in must if build.LAUNCHES[k] == 0]
                        check(not missing, f"{model} {label}: kernels never launched: {missing}")
                        # a bf16 model's prefill attention runs K5/K7's tiles
                        # alone (f32 takes their SIMT bodies by design)
                        simt = {k: build.LAUNCHES[k] for k in ("flash_prefill_simt",
                                                               "flash_prefill_quant_simt")}
                        check(dtype != torch.bfloat16 or not any(simt.values()),
                              f"{model} {label}: a SIMT body launched: {simt}")
                        # the decode steps replay one graph: the forward ran at
                        # T=1 twice, in its eager warm-up step and its capture
                        check(len(graphs) == 1, f"{model} {label}: decode graphs {graphs}")
                        want = {k: 2 * n_routed if k == route else 0 for k in calls}
                        check(calls == want, f"{model} {label}: T=1 attention took {calls}, "
                              f"not the {route} route")
                        # the masked route (a quantized cache at a head dim
                        # that 32 does not divide) launches no attention kernel
                        attn = {k: build.LAUNCHES[k] for k in (*dense_attn, *quant_attn)}
                        check(route != "masked" or not any(attn.values()),
                              f"{model} {label}: the masked route launched {attn}")
            firsts[label] = runs["kernel"][0]
            if cfgp.n_expert:
                log(f"[path] {model}, {label}: the plain path routed as the kernel path; "
                    f"{len(diffs)} real rows differ from its own top-{cfgp.n_expert_used} "
                    f"{json.dumps(diffs)}")
                check(all(d["tie"] for d in diffs),
                      f"{model} {label}: the kernel path routed a row away from the plain "
                      f"path's top-{cfgp.n_expert_used} other than by a tie swap")
            for i, (a, b) in enumerate(zip(runs["kernel"], runs["plain"])):
                what = ("prefill" if i == 0 else "prefill chunk 2" if i == len(forced) + 1
                        else f"decode step {i}")
                what = f"{label}, {what}"
                a_t, b_t = torch.from_numpy(a), torch.from_numpy(b)
                # chameleon's image tokens hold -FLT_MAX on both paths; the
                # error is taken over the other ids
                sup = b_t == NEG_FLT_MAX
                check(torch.equal(a_t == NEG_FLT_MAX, sup)
                      and bool(sup.any()) == (cfgp.arch == "chameleon" and Vp > 8196),
                      f"{model} {what}: the -FLT_MAX logits differ between the paths")
                err = rel_err(a_t[~sup], b_t[~sup])
                check(a.shape == (Vp,) and bool(torch.isfinite(a_t).all()),
                      f"{model} {what}: logits not finite of shape [{Vp}]")
                log(f"[path] {model}, {cfgp.n_layer} layers, {what}: logits max rel err {err:.3e} "
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

    def verify_path_check(cfgp, p_gpu, p_cpu, prompt):
        """Speculative decoding's verify forwards, on the card and on the
        CPU, the same params (bf16, dense cache): after the prompt's prefill,
        the target step over T = 5 and then T = 9 tokens, unpadded, with the
        logits of every position (the on-device round's target step at k =
        4, K1 at 5 rows, and at k = 8, K2 at 9 rows: Engine._step, as
        runtime/speculative.py calls it), then Engine.prefill_logits of 9
        tokens (the host-driven verify, padded to the 32-row bucket: K2);
        every position's logits within TOL_PATH, each step's launches
        logged and the kernels of its route checked."""
        t_case = time.perf_counter()
        V2, runs = cfgp.n_vocab, {}
        for name, params, device in (("kernel", p_gpu, "cuda"), ("plain", p_cpu, "cpu")):
            eng = Engine(params, cfgp, batch_size=1, max_seq=1024, device=device)
            eng.prefill(prompt)
            steps = []
            for T in (5, 9):
                build.reset_launches()
                toks = torch.tensor([[(7919 * (j + T)) % V2 for j in range(T)]], device=eng.device)
                wp = int(eng.seq_len[0])
                logits = eng._step(toks, eng._dev_i32([wp]), T, kv_cap=eng._kv_cap(wp + T))[0]
                eng.seq_len[0] += T
                steps.append((f"verify step T={T}", logits.cpu(), dict(build.LAUNCHES)))
            build.reset_launches()
            steps.append(("prefill_logits of 9 tokens",
                          torch.from_numpy(eng.prefill_logits(prompt[:9])), dict(build.LAUNCHES)))
            runs[name] = steps
            del eng
        for (what, a, launches), (_, b, _) in zip(runs["kernel"], runs["plain"]):
            used = {k: v for k, v in launches.items() if v}
            T = a.shape[0]
            weights = "qmv" if T <= 8 and what.startswith("verify") else "qgemm"
            check(a.shape == b.shape == (T, V2) and bool(torch.isfinite(a).all()),
                  f"8B widths {what}: logits not finite of shape [{T}, {V2}]")
            check(used.get(weights, 0) > 0 and used.get("flash_prefill", 0) == cfgp.n_layer
                  and used.get("qgemm" if weights == "qmv" else "qmv", 0) == 0,
                  f"8B widths {what}: launches {used}, not {weights} and K5 a layer")
            errs = [rel_err(a[i], b[i]) for i in range(T)]
            log(f"[path] 8B widths, {cfgp.n_layer} layers, {what}: every position's logits, "
                f"max rel err {max(errs):.3e} (tol {TOL_PATH:.0e}; per position "
                f"{', '.join(f'{e:.1e}' for e in errs)}), argmax agree at "
                f"{int((a.argmax(-1) == b.argmax(-1)).sum())} of {T}; kernel launches "
                f"{json.dumps(used)}")
            check(max(errs) <= TOL_PATH, f"8B widths {what}: kernel path disagrees with the "
                  "plain path")
        log(f"[path] 8B widths, verify forwards: {time.perf_counter() - t_case:.1f}s")

    def spec_round_check(cfgp, p_gpu, prompt, k=4):
        """One on-device speculative round (OnDeviceSpeculative.round: k + 1
        draft steps of a 1-layer self-draft, the T = k + 1 target step, the
        accept and the device state) captured as a CUDA graph against the
        same round called from Python, from the same state: one token is
        one round (a round emits 1 to k + 1). The tokens, the stats, the lengths and every K/V slot
        the round wrote, in the target's and the draft's cache, equal bit
        for bit; the replay's launches are the captured ones."""
        t = Engine(p_gpu, cfgp, batch_size=1, max_seq=1024)
        d = Engine(truncated_draft_params(p_gpu, 1), dataclasses.replace(cfgp, n_layer=1),
                   batch_size=1, max_seq=1024)
        first = int(t.prefill(prompt).argmax())
        d.prefill(prompt)
        pre = (int(t.seq_len[0]), int(d.seq_len[0]))
        sp = OnDeviceSpeculative(t, d, k=k)
        got = {}
        for way in ("eager", "graph (capture)", "graph"):
            t.seq_len[0], d.seq_len[0] = pre
            build.reset_launches()
            toks, stats = sp.generate_greedy(first, 1, eager=way == "eager")
            torch.cuda.synchronize()
            wrote = [pl[:, 0, pre[0]:pre[0] + k + 1].clone() for pl in t.cache.planes()]
            wrote += [pl[:, 0, pre[1]:pre[1] + k + 1].clone() for pl in d.cache.planes()]
            got[way] = (toks.tolist(), stats, (int(t.seq_len[0]), int(d.seq_len[0])), wrote,
                        dict(build.LAUNCHES), sp.replays, sp.host_reads)
        (e_toks, e_stats, e_len, e_kv, _, _, _), (g_toks, g_stats, g_len, g_kv, launches,
                                                  replays, reads) = got["eager"], got["graph"]
        captured = next(iter(sp.graphs.values()))[1]
        same_kv = all(torch.equal(a, b) for a, b in zip(e_kv, g_kv))
        log(f"[path] 8B widths, one speculative round (k {k}, 1-layer self-draft): eager "
            f"{e_toks} {e_stats} lengths {e_len}; graph {g_toks} {g_stats} lengths {g_len}; the "
            f"written K/V equal bit for bit: {same_kv}; {replays} replay, {reads} host reads; "
            f"captured launches {json.dumps(captured)}")
        check(e_stats["rounds"] == 1 and len(sp.graphs) == 1,
              f"speculative round: {e_stats['rounds']} rounds, {len(sp.graphs)} graphs")
        check(got["graph (capture)"][:3] == got["eager"][:3] and g_toks == e_toks
              and g_stats == e_stats and g_len == e_len and same_kv,
              "the captured speculative round differs from its eager run")
        want = {kk: captured.get(kk, 0) * replays for kk in launches}
        check(launches == want and all(captured.get(kk, 0) for kk in ("qmv", *dense_attn)),
              f"speculative round launches {launches} are not the captured {captured} x "
              f"{replays}, or lack K1/K4/K5")
        del t, d, sp

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
    verify_path_check(cfg2, p_gpu, p_cpu, prompt20)
    spec_round_check(cfg2, p_gpu, prompt20)
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
    # digits in llama.cpp's irregular element order); at 1 layer (the
    # script's time: a 2-layer Mixtral-wide CPU copy holds ~11 GB decoded),
    # whose kinds are the 2-layer model's
    mcfg1 = mixtral_8x7b_config(n_layer=1)
    for preset, dtype in (("Q5_K_M", torch.bfloat16), ("Q3_K_M", torch.bfloat16),
                          ("IQ2_M", torch.bfloat16), ("IQ3_XXS", torch.float32),
                          ("TQ1_0", torch.bfloat16)):
        p_gpu, p_cpu = two_copies(mcfg1, preset)
        bf16 = dtype == torch.bfloat16
        path_check("Mixtral widths", mcfg1, p_gpu, p_cpu, [
            (f"{preset} kv dense{'' if bf16 else ' f32'}", "dense", {}, prompt20m,
             ("qmv_id", "qgemm_id") if bf16 else ("qmv", "qmv_id"), "stacked", dtype)],
            [11, 12345, 777, 31000], 33)
        del p_gpu, p_cpu
        torch.cuda.empty_cache()
    # the Qwen and Gemma families: 2 layers at each config's own widths (the
    # published member's), Q4_K_M's kinds; Gemma-3 at Gemma-3-4B's widths
    # (a CPU copy of Gemma-3-12B's 262208 x 3840 head takes 4 GB decoded)
    # and 6 layers, so that one of them is global (pattern 6), its
    # 1100-token prompt past the 1024-token window: the ring wraps within
    # the prompt, and the decode steps and the second chunk read it;
    # Qwen2-57B-A14B at 1 layer (its layers are alike; for time)
    prompt20f = [(i * 7919) % 151936 for i in range(2, 22)]
    for model, cfgf, cases, max_seq in (
            ("Qwen2.5-7B widths", qwen2_5_7b_config(n_layer=2), [
                ("kv dense", "dense", {}, prompt20f, ("qmv", "qgemm", *dense_attn), "stacked")],
             1024),
            ("Qwen2.5-0.5B widths", qwen2_5_0_5b_config(n_layer=2), [
                ("kv dense", "dense", {}, prompt20f, ("qmv", "qgemm", *dense_attn), "stacked")],
             1024),
            ("Qwen3-8B widths", qwen3_8b_config(n_layer=2), [
                ("kv dense", "dense", {}, prompt20f, ("qmv", "qgemm", *dense_attn), "stacked")],
             1024),
            ("Qwen3-30B-A3B widths", qwen3_30b_a3b_config(n_layer=2), [
                ("kv dense", "dense", {}, prompt20f, ("qmv", "qgemm", "qmv_id", "qgemm_id",
                                                      *dense_attn), "stacked")], 64),
            ("Qwen2-57B-A14B widths", qwen2_57b_a14b_config(n_layer=1), [
                ("kv dense", "dense", {}, prompt20f, ("qmv", "qgemm", "qmv_id", "qgemm_id",
                                                      *dense_attn), "stacked")], 64),
            ("Gemma-2-9B widths", gemma2_9b_config(n_layer=2), [
                ("kv dense (ring)", "dense", {}, prompt20f, ("qmv", "qgemm", *dense_attn),
                 "stacked"),
                ("kv q8_0", "q8_0", {}, prompt20f, ("qmv", "qgemm", *quant_attn), "stacked")],
             8192),
            ("Gemma-3-4B widths", gemma3_4b_config(n_layer=6), [
                ("kv dense (ring), 1100-token prompt", "dense", {},
                 [(i * 7919) % 262208 for i in range(2, 1102)], ("qmv", "qgemm", *dense_attn),
                 "stacked")], 1280)):
        p_gpu, p_cpu = two_copies(cfgf, "Q4_K_M")
        path_check(model, cfgf, p_gpu, p_cpu, cases, [11, 12345, 777, 90000], max_seq)
        del p_gpu, p_cpu
        torch.cuda.empty_cache()
    # the layer-norm families, Q4_K_M, 2 layers of each config's widths:
    # Falcon-7B (71 query heads over one kv head: K4-K7 at rep 71; K 4544 in
    # the 32-block kinds) and Phi-2 (D 80: K4/K5 on the dense cache, the
    # masked path on q8_0, the JAX route) with both caches, one case each
    # for the others (learned positions on GPT-2 and StarCoderBase-7B,
    # whose 32 query heads share one kv head; attn_norm_2 on Falcon-40B;
    # gptneox's two norms; GPT-J's interleaved partial rope at D 256).
    # StableLM-2, StarCoder2, StarCoderBase and GPT-J run as f32 models: in
    # bf16 their synthetic models' own plain paths move past TOL_PATH under
    # noise of about a bf16 rounding on every product
    # (tools/path_sensitivity.py --ftype Q4_K_M at eps 1e-3, 2 layers, on
    # the CPU: 0.056-0.481, 0.119-0.190, 0.057-0.075 and 0.035-0.058 of max
    # |logit|; Pythia 0.035-0.038), so a bf16 comparison cannot tell a
    # kernel defect from that sensitivity; in f32 the paths differ by
    # summation order alone (qmv takes every f32 row, K5/K7 their f32
    # bodies; phase 3 holds the bf16 tiles at these heads, phase 5 runs them)
    prompt20n = [(i * 7919) % 49152 for i in range(2, 22)]
    q8_attn = ("qmv", "qgemm", *quant_attn)
    f32_dense = ("qmv", "flash_decode_dense", "flash_prefill_simt")
    f32_q8 = ("qmv", "flash_decode_quant", "flash_prefill_quant_simt")
    for model, cfgf, cases, max_seq in (
            ("Falcon-7B widths", falcon_7b_config(n_layer=2), [
                ("kv dense", "dense", {}, prompt20n, ("qmv", "qgemm", *dense_attn), "stacked"),
                ("kv q8_0", "q8_0", {}, prompt20n, q8_attn, "stacked")], 1024),
            ("Phi-2 widths", phi2_config(n_layer=2), [
                ("kv dense", "dense", {}, prompt20n, ("qmv", "qgemm", *dense_attn), "stacked"),
                ("kv q8_0 (masked)", "q8_0", {}, prompt20n, ("qmv", "qgemm"), "masked")],
             1024),
            ("GPT-2 widths", gpt2_config(n_layer=2), [
                ("kv dense", "dense", {}, prompt20n, ("qmv", "qgemm", *dense_attn), "stacked")],
             1024),
            ("StableLM-2-1.6B widths", stablelm2_1_6b_config(n_layer=2), [
                ("kv dense f32", "dense", {}, prompt20n, f32_dense, "stacked", torch.float32)],
             1024),
            ("StarCoder2-7B widths", starcoder2_7b_config(n_layer=2), [
                ("kv dense f32", "dense", {}, prompt20n, f32_dense, "stacked", torch.float32)],
             1024),
            ("StarCoderBase-7B widths", starcoderbase_7b_config(n_layer=2), [
                ("kv q8_0 f32", "q8_0", {}, prompt20n, f32_q8, "stacked", torch.float32)],
             1024),
            ("Pythia-6.9B widths", pythia_6_9b_config(n_layer=2), [
                ("kv dense", "dense", {}, prompt20n, ("qmv", "qgemm", *dense_attn), "stacked")],
             1024),
            ("GPT-J-6B widths", gptj_6b_config(n_layer=2), [
                ("kv dense f32", "dense", {}, prompt20n, f32_dense, "stacked", torch.float32)],
             1024),
            ("Falcon-40B widths", falcon_40b_config(n_layer=2), [
                ("kv dense", "dense", {}, prompt20n, ("qmv", "qgemm", *dense_attn), "stacked")],
             1024)):
        p_gpu, p_cpu = two_copies(cfgf, "Q4_K_M")
        path_check(model, cfgf, p_gpu, p_cpu, cases, [11, 12345, 777, 31000], max_seq)
        del p_gpu, p_cpu
        torch.cuda.empty_cache()
    # the Phi-3, Command-R and DeepSeek-V2 families and Gemma-1, Q4_K_M: 2
    # layers of each config's widths (DeepSeek: the dense lead layer and a
    # MoE one); Command R7B at 4, so that one layer is global (pattern 4)
    # and without rope, at max_seq 8192: the ring beside the full store
    prompt20v = [(i * 7919) % 32064 for i in range(2, 22)]
    moe_attn = ("qmv", "qgemm", "qmv_id", "qgemm_id")
    for model, cfgf, cases, max_seq in (
            ("DeepSeek-V2-Lite widths", deepseek_v2_lite_config(n_layer=2), [
                ("kv dense", "dense", {}, prompt20v, (*moe_attn, *dense_attn), "stacked"),
                ("kv q8_0", "q8_0", {}, prompt20v, (*moe_attn, *quant_attn), "stacked")], 1024),
            ("DeepSeek-V2 widths", deepseek_v2_config(n_layer=2), [
                ("kv dense", "dense", {}, prompt20v, (*moe_attn, *dense_attn), "stacked")], 64),
            ("Phi-3.5-mini widths", phi3_5_mini_config(n_layer=2), [
                ("kv dense", "dense", {}, prompt20v, ("qmv", "qgemm", *dense_attn), "stacked"),
                ("kv q8_0", "q8_0", {}, prompt20v, ("qmv", "qgemm", *quant_attn), "stacked")],
             1024),
            ("Command-R widths", command_r_v01_config(n_layer=2), [
                ("kv dense", "dense", {}, prompt20v, ("qmv", "qgemm", *dense_attn), "stacked")],
             1024),
            ("Command R7B widths", command_r7b_config(n_layer=4), [
                ("kv dense (ring)", "dense", {}, prompt20v, ("qmv", "qgemm", *dense_attn),
                 "stacked")], 8192),
            ("Gemma-7B widths", gemma_7b_config(n_layer=2), [
                ("kv dense", "dense", {}, prompt20v, ("qmv", "qgemm", *dense_attn), "stacked")],
             1024)):
        p_gpu, p_cpu = two_copies(cfgf, "Q4_K_M")
        path_check(model, cfgf, p_gpu, p_cpu, cases, [11, 12345, 777, 31000], max_seq)
        del p_gpu, p_cpu
        torch.cuda.empty_cache()
    # Llama 4, the OLMo families and the scaled families, Q4_K_M: 2 layers of
    # each config's widths. Llama-4-Scout at 1 layer (its first layers are
    # alike; for time), chunked: the
    # masked path on every layer, prefill and decode (the JAX route for a
    # chunked model), no attention kernel; top 1 of 16 experts beside the
    # shared one, so its 40-token prompt (40 pairs) takes the grouped GEMM;
    # its NoPE layers (every 4th) differ only in torch glue and run in phase
    # 5. Granite-3.1-8B dense and q8_0 (the three scales; K4-K7 at attention
    # scale 1/128), OLMoE-1B-7B, OLMo-2-7B dense and q8_0 (post-norm-only,
    # whole-projection q/k norms), OLMo-7B (no norm tensor, clamp_kqv 8),
    # Granite-3.1-3B-A800M and MiniCPM-2B (its scale defaults)
    prompt40 = [(i * 7919) % 49152 for i in range(2, 42)]
    prompt20g = prompt40[:20]
    for model, cfgf, cases, max_seq in (
            ("Llama-4-Scout widths", llama4_scout_config(n_layer=1), [
                ("kv dense (masked)", "dense", {}, prompt40, moe_attn, "masked")], 1024),
            ("Granite-3.1-8B widths", granite_3_1_8b_config(n_layer=2), [
                ("kv dense", "dense", {}, prompt20g, ("qmv", "qgemm", *dense_attn), "stacked"),
                ("kv q8_0", "q8_0", {}, prompt20g, ("qmv", "qgemm", *quant_attn), "stacked")],
             1024),
            ("OLMoE-1B-7B widths", olmoe_1b_7b_config(n_layer=2), [
                ("kv dense", "dense", {}, prompt20g, (*moe_attn, *dense_attn), "stacked")], 1024),
            ("OLMo-2-7B widths", olmo2_7b_config(n_layer=2), [
                ("kv dense", "dense", {}, prompt20g, ("qmv", "qgemm", *dense_attn), "stacked"),
                ("kv q8_0", "q8_0", {}, prompt20g, ("qmv", "qgemm", *quant_attn), "stacked")],
             1024),
            ("OLMo-7B widths", olmo_7b_config(n_layer=2), [
                ("kv dense", "dense", {}, prompt20g, ("qmv", "qgemm", *dense_attn), "stacked")],
             1024),
            ("Granite-3.1-3B-A800M widths", granite_3_1_3b_a800m_config(n_layer=2), [
                ("kv dense", "dense", {}, prompt20g, (*moe_attn, *dense_attn), "stacked")], 1024),
            ("MiniCPM-2B widths", minicpm_2b_config(n_layer=2), [
                ("kv dense", "dense", {}, prompt20g, ("qmv", "qgemm", *dense_attn), "stacked")],
             1024)):
        p_gpu, p_cpu = two_copies(cfgf, "Q4_K_M")
        path_check(model, cfgf, p_gpu, p_cpu, cases, [11, 12345, 777, 31000], max_seq)
        del p_gpu, p_cpu
        torch.cuda.empty_cache()
    # the ALiBi families, the llama-graph clones and the squared-ReLU FFN,
    # Q4_K_M: 2 layers of each config's widths. BLOOM-7B1, MPT-7B, Jais-13B
    # and Refact-1.6B attend through the masked path on every layer, prefill
    # and decode, with each head's slope times the distance (the JAX route:
    # no attention kernel), BLOOM over the dense and the q8_0 cache (the
    # dequantized planes); Jais-13B's ffn_down at K 13653 is F16, a dense
    # product; Refact-1.6B's 32 query heads share one kv head. The clones
    # and relu^2 take K4/K5: xverse, baichuan and internlm2 (interleaved
    # rope), exaone, orion (layer norm), codeshell (GPT-2's block with
    # rope), Qwen-7B (its FFN half its feed_forward_length), PLaMo-13B (the
    # parallel residual without ffn_norm, 40 heads over 5), Minitron-4B
    # (layer norm, partial rope, relu^2) and AFM-4.5B (relu^2). BLOOM-7B1,
    # MPT-7B, Jais-13B, Orion-14B and CodeShell-7B run as f32 models: in
    # bf16 their synthetic models' own plain paths move past TOL_PATH under
    # noise of about a bf16 rounding on every product
    # (tools/path_sensitivity.py --ftype Q4_K_M at eps 1e-3, 2 layers, on
    # the CPU: 0.044-0.076, 0.063-0.075, 0.059-0.160, 0.202-0.634 and
    # 0.036-0.083 of max |logit|; the others 0.003-0.008, Minitron-4B
    # 0.030-0.046), as for four layer-norm families above
    prompt20a = [(i * 7919) % 49216 for i in range(2, 22)]
    stacked = ("qmv", "qgemm", *dense_attn)
    for model, cfgf, cases, max_seq in (
            ("BLOOM-7B1 widths", bloom_7b1_config(n_layer=2), [
                ("kv dense f32 (masked)", "dense", {}, prompt20a, ("qmv",), "masked",
                 torch.float32),
                ("kv q8_0 f32 (masked)", "q8_0", {}, prompt20a, ("qmv",), "masked",
                 torch.float32)], 1024),
            ("MPT-7B widths", mpt_7b_config(n_layer=2), [
                ("kv dense f32 (masked)", "dense", {}, prompt20a, ("qmv",), "masked",
                 torch.float32)], 1024),
            ("Jais-13B widths", jais_13b_config(n_layer=2), [
                ("kv dense f32 (masked)", "dense", {}, prompt20a, ("qmv",), "masked",
                 torch.float32)], 1024),
            ("Refact-1.6B widths", refact_1_6b_config(n_layer=2), [
                ("kv dense (masked)", "dense", {}, prompt20a, ("qmv", "qgemm"), "masked")],
             1024),
            ("XVERSE-7B widths", xverse_7b_config(n_layer=2), [
                ("kv dense", "dense", {}, prompt20a, stacked, "stacked")], 1024),
            ("Baichuan2-7B widths", baichuan2_7b_config(n_layer=2), [
                ("kv dense", "dense", {}, prompt20a, stacked, "stacked")], 1024),
            ("InternLM2-7B widths", internlm2_7b_config(n_layer=2), [
                ("kv dense", "dense", {}, prompt20a, stacked, "stacked")], 1024),
            ("EXAONE-3.0-7.8B widths", exaone_3_7_8b_config(n_layer=2), [
                ("kv dense", "dense", {}, prompt20a, stacked, "stacked")], 1024),
            ("Orion-14B widths", orion_14b_config(n_layer=2), [
                ("kv dense f32", "dense", {}, prompt20a, f32_dense, "stacked", torch.float32)],
             1024),
            ("CodeShell-7B widths", codeshell_7b_config(n_layer=2), [
                ("kv dense f32", "dense", {}, prompt20a, f32_dense, "stacked", torch.float32)],
             1024),
            ("Qwen-7B widths", qwen_7b_config(n_layer=2), [
                ("kv dense", "dense", {}, prompt20a, stacked, "stacked")], 1024),
            ("PLaMo-13B widths", plamo_13b_config(n_layer=2), [
                ("kv dense", "dense", {}, prompt20a, stacked, "stacked")], 1024),
            ("Minitron-4B widths", minitron_4b_config(n_layer=2), [
                ("kv dense", "dense", {}, prompt20a, stacked, "stacked")], 1024),
            ("AFM-4.5B widths", afm_4_5b_config(n_layer=2), [
                ("kv dense", "dense", {}, prompt20a, stacked, "stacked")], 1024)):
        p_gpu, p_cpu = two_copies(cfgf, "Q4_K_M")
        path_check(model, cfgf, p_gpu, p_cpu, cases, [11, 12345, 777, 31000], max_seq)
        del p_gpu, p_cpu
        torch.cuda.empty_cache()
    # the MoE variants, Q4_K_M, at each config's widths; a 20-token prompt
    # routes its (token, slot) rows through the grouped GEMM, each decode
    # step through the gather. DeepSeek-MoE-16B and dots.llm1 at 2 layers
    # (the dense lead layer and a MoE one; dots1's sigmoid router with its
    # selection bias, which the plain path's forced routing repeats; dots1
    # over the dense and the q8_0 cache), Ling-lite, Phi-3.5-MoE (rms norms
    # with biases, the short rope factors) and DBRX (layer norms, clamp_kqv
    # 8, the fused attn_qkv, top 4 of 16; dense and q8_0, as an f32 model:
    # its bf16 plain path moves 0.046-0.091 of max |logit| under noise of
    # about a bf16 rounding on every product, tools/path_sensitivity.py
    # --model dbrx --ftype Q4_K_M, 2 layers, on the CPU; the others
    # 0.0002-0.0068; in f32 qmv and K10 take every row, K5/K7 their f32
    # bodies) at 2, DBRX at 1 (its layers are alike; for time), Grok-1
    # (softcap 30, post-norms, GELU experts, the tied 131072-row head) and
    # Snowflake Arctic (the dense FFN and the MoE branch on the layer input)
    # at 1: each plain copy keeps its stacks decoded at 4 bytes a weight,
    # DBRX's layer ~12 GB and Grok-1's ~19 GB of host memory. Arctic
    # runs here with its 128 experts cut to 16, each expert's widths and
    # top 2 kept: one layer's 128 would hold ~54 GB decoded; phases 3 and 5
    # run all 128
    prompt20e = [(i * 7919) % 32000 for i in range(2, 22)]
    moe_stacked = (*moe_attn, *dense_attn)
    arctic16 = dataclasses.replace(arctic_config(n_layer=1), n_expert=16)
    for model, cfgf, cases, max_seq in (
            ("DeepSeek-MoE-16B widths", deepseek_moe_16b_config(n_layer=2), [
                ("kv dense", "dense", {}, prompt20e, moe_stacked, "stacked")], 1024),
            ("dots.llm1 widths", dots1_config(n_layer=2), [
                ("kv dense", "dense", {}, prompt20e, moe_stacked, "stacked"),
                ("kv q8_0", "q8_0", {}, prompt20e, (*moe_attn, *quant_attn), "stacked")],
             1024),
            ("Ling-lite widths", ling_lite_config(n_layer=2), [
                ("kv dense", "dense", {}, prompt20e, moe_stacked, "stacked")], 1024),
            ("Phi-3.5-MoE widths", phi3_5_moe_config(n_layer=2), [
                ("kv dense", "dense", {}, prompt20e, moe_stacked, "stacked")], 1024),
            ("DBRX widths", dbrx_config(n_layer=1), [
                ("kv dense f32", "dense", {}, prompt20e, (*f32_dense, "qmv_id"), "stacked",
                 torch.float32),
                ("kv q8_0 f32", "q8_0", {}, prompt20e, (*f32_q8, "qmv_id"), "stacked",
                 torch.float32)], 64),
            ("Grok-1 widths", grok_1_config(n_layer=1), [
                ("kv dense", "dense", {}, prompt20e, moe_stacked, "stacked")], 64),
            ("Arctic widths, 16 of its 128 experts", arctic16, [
                ("kv dense", "dense", {}, prompt20e, moe_stacked, "stacked")], 64)):
        p_gpu, p_cpu = two_copies(cfgf, "Q4_K_M")
        path_check(model, cfgf, p_gpu, p_cpu, cases, [11, 12345, 777, 31000], max_seq)
        del p_gpu, p_cpu
        torch.cuda.empty_cache()
    # the last decoders, at each config's widths, Q4_K_M unless named:
    # MiniCPM3-4B (MLA with a q LoRA at K 96 / V 64, its residual scale not
    # applied, the longrope tables; dense and q8_0) and PLM-1.8B (MLA
    # without a q LoRA, relu^2, tied) at 4 layers; GLM-4-9B-0414 (biased
    # q/k/v, the fused gate_up, pre- and post-norms, rope over half of each
    # head, 16 query heads a kv head) and glm-4-9b-chat (biased attn_qkv) at
    # 4; Chameleon-7B (per-head layer norms at eps 0, the image tokens'
    # -FLT_MAX) at 4 and the swin Chameleon-30B at 2; BitNet b1.58-large in
    # TQ2_0 and TQ1_0 (sub-norms, each product's scale, its own launch) at
    # 4; OpenELM-3B at the first 8 of its 36 layers (12 and 16 query heads
    # over 3 and 4 kv heads, the cache 4 wide: the masked path on every
    # layer, no attention kernel, the JAX route; dense and q8_0; phase 5 runs
    # all 36) and the deci pattern at
    # Nemotron-51B's widths over its first 5 layers (GQA at 8 and 2 kv
    # heads, attention-free, linear attention, linear attention without an
    # FFN; the masked path; dense and q8_0). GLM-4-9B-0414 runs as an f32
    # model: its synthetic bf16 plain path moves 0.012-0.084 of max |logit|
    # under noise of about a bf16 rounding on every product
    # (tools/path_sensitivity.py --model glm4-9b-0414 --ftype Q4_K_M
    # --layers 4, on the CPU: its post-norms of ones rescale each branch's
    # small output to unit size), past TOL_PATH; in f32 the paths differ by
    # summation order alone (qmv takes every f32 row, K5 its f32 body;
    # phase 3 holds the bf16 tiles at its heads, phase 5 runs them)
    prompt20d = [(i * 7919) % 32000 for i in range(2, 22)]
    q8_stacked = ("qmv", "qgemm", *quant_attn)
    for model, cfgf, ftype, cases, max_seq in (
            ("MiniCPM3-4B widths", minicpm3_4b_config(n_layer=4), "Q4_K_M", [
                ("kv dense", "dense", {}, prompt20d, stacked, "stacked"),
                ("kv q8_0", "q8_0", {}, prompt20d, q8_stacked, "stacked")], 1024),
            ("PLM-1.8B widths", plm_1_8b_config(n_layer=4), "Q4_K_M", [
                ("kv dense", "dense", {}, prompt20d, stacked, "stacked")], 1024),
            ("GLM-4-9B-0414 widths", glm4_9b_0414_config(n_layer=4), "Q4_K_M", [
                ("kv dense f32", "dense", {}, prompt20d, f32_dense, "stacked", torch.float32)],
             1024),
            ("glm-4-9b-chat widths", glm_4_9b_chat_config(n_layer=4), "Q4_K_M", [
                ("kv dense", "dense", {}, prompt20d, stacked, "stacked")], 1024),
            ("Chameleon-7B widths", chameleon_7b_config(n_layer=4), "Q4_K_M", [
                ("kv dense", "dense", {}, prompt20d, stacked, "stacked")], 1024),
            ("Chameleon-30B widths (swin)", chameleon_30b_config(n_layer=2), "Q4_K_M", [
                ("kv dense", "dense", {}, prompt20d, stacked, "stacked")], 1024),
            ("BitNet b1.58-large widths", bitnet_b1_58_large_config(n_layer=4), "TQ2_0", [
                ("TQ2_0 kv dense", "dense", {}, prompt20d, stacked, "stacked")], 1024),
            ("BitNet b1.58-large widths", bitnet_b1_58_large_config(n_layer=4), "TQ1_0", [
                ("TQ1_0 kv dense", "dense", {}, prompt20d, stacked, "stacked")], 1024),
            ("OpenELM-3B widths", openelm_3b_config(n_layer=8), "Q4_K_M", [
                ("kv dense (masked)", "dense", {}, prompt20d, ("qmv", "qgemm"), "masked"),
                ("kv q8_0 (masked)", "q8_0", {}, prompt20d, ("qmv", "qgemm"), "masked")],
             1024),
            ("deci pattern at Nemotron-51B widths", deci_51b_config(n_layer=5), "Q4_K_M", [
                ("kv dense (masked)", "dense", {}, prompt20d, ("qmv", "qgemm"), "masked"),
                ("kv q8_0 (masked)", "q8_0", {}, prompt20d, ("qmv", "qgemm"), "masked")],
             1024)):
        p_gpu, p_cpu = two_copies(cfgf, ftype)
        path_check(model, cfgf, p_gpu, p_cpu, cases, [11, 12345, 777, 31000], max_seq)
        del p_gpu, p_cpu
        torch.cuda.empty_cache()
    host_pool[0] = torch.empty(0, dtype=torch.uint8)
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
            t_run = time.perf_counter()
            max_seq, n_tok, *chunk = sizes or (1024, N_DECODE)
            prompt = [(j * 31337) % Vm for j in range(prompt_len)]
            tag = f"[{model} {name} run {i + 1}]"
            with env_vars(env):
                eng = Engine(params, cfgm, batch_size=1, max_seq=max_seq, kv_type=kv_type)

                def prefill_all():
                    """The prompt's prefill, in the run's chunks if it names them."""
                    step = chunk[0] if chunk else prompt_len
                    for off in range(0, prompt_len, step):
                        logits = eng.prefill(prompt[off:off + step])
                    return logits

                c = eng.cache
                kv_bytes = sum(t.nbytes for t in c.planes())
                log(f"{tag} cache {type(c).__name__}"
                    + (f" (ring of {c.window} slots for {sum(c.swa_layers)} of {cfgm.n_layer} "
                       "layers)" if eng.ring else "")
                    + (f", prompt in chunks of {chunk[0]}" if chunk else ""))
                planes = [w for layer in eng.params["layers"] for w in layer.values()
                          if isinstance(w, WireTensor) and w.qi8 is not None]
                if planes:
                    log(f"{tag} int8 prefill planes on {len(planes)} weights: "
                        f"{sum(w.qi8.nbytes + w.ws8T.nbytes for w in planes) / 1e9:.3f} GB")
                ttfts = []
                for _ in range(4):  # the first is a warm-up (allocator, first launches)
                    eng.reset()
                    t0 = time.perf_counter()
                    prefill_all()
                    ttfts.append(time.perf_counter() - t0)
                ttft = statistics.median(ttfts[1:])

                def decode(run_tokens):
                    eng.reset()
                    first = int(prefill_all().argmax())
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
                logits = prefill_all()
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
                             "total": launches, "tokens": toks, "ms": dt / n_tok * 1e3,
                             "peak": peak,
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
                first = int(prefill_all().argmax())
                host_toks, tok = [], first
                for _ in range(8):
                    tok = int(eng.decode_one([tok])[0].argmax())
                    host_toks.append(tok)
                check(host_toks == [int(t) for t in toks[0, :8]],
                      f"{tag} greedy loop {toks[0, :8]} != decode_one {host_toks}")
                log(f"{tag} greedy loop and decode_one agree on the first 8 tokens: {host_toks}")
            del eng, c, planes
            torch.cuda.empty_cache()
            log(f"{tag} wall time {time.perf_counter() - t_run:.1f}s")
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

    def spec_runs(params, cfgm, plain):
        """Phase 5's speculative and state runs on the 8B at full depth, a
        PROMPT_LEN-token prompt: the plain greedy tokens and logits first,
        one decode_one (a graph replay) a step, which must be the counted
        dense run's `plain` tokens; then OnDeviceSpeculative (k = 4) with the
        full-depth self-draft (the target's weights: the cost of a round when
        drafts are accepted) and a 4-layer self-draft, N_DECODE tokens, each
        after a call that captures the round's graph: its launches the
        captured ones times the replays; SpeculativeDecoder with the
        Llama-3.2-1B-shaped draft (its default n_draft 8 and p_min 0.75),
        greedy, and seeded-sampled twice (the same tokens); a state round
        trip with the dense and the q8_0 cache (the continuation after
        restore equals the uninterrupted one); and one server run with -md
        and slot save/restore. The greedy speculative tokens equal the plain
        ones or part from them first at a near-tie of the plain logits:
        the token taken within TIE_ULPS bf16 ulps of the top logit (the
        verify step's K5 and K1 at k + 1 rows, or K2, round otherwise than
        the decode step's K4 and K1 at one row, each held against its plain
        version in phase 3; the synthetic 8B's logits tie often: the
        parting position is printed)."""
        from llamacog_tpu_torch.models.loader import Model
        from llamacog_tpu_torch.server.server import serve
        from llamacog_tpu_torch.utils.synthetic import synthetic_vocab

        t_phase = time.perf_counter()
        Vm, n, card = cfgm.n_vocab, N_DECODE, nvidia_smi_line()
        prompt = [(j * 31337) % Vm for j in range(PROMPT_LEN)]
        plain_ms = statistics.median(plain["graph_ms"])

        def greedy_ref(eng, ids, n_tok):
            """The prefill's greedy token, then the plain greedy tokens and
            each step's logits (decode_one)."""
            tok = int(eng.prefill(ids).argmax())
            toks, logits = [tok], []
            for _ in range(n_tok):
                lg = eng.decode_one([tok])[0]
                tok = int(lg.argmax())
                toks.append(tok)
                logits.append(lg)
            return toks[0], toks[1:], logits

        def agree(tag, toks, ref_toks, ref_logits):
            """The greedy speculative tokens against the plain ones: equal, or
            parting first at a near-tie of the plain logits."""
            toks = [int(x) for x in toks]
            part = next((j for j, (a, b) in enumerate(zip(toks, ref_toks)) if a != b), None)
            if part is None:
                log(f"{tag} its {len(toks)} tokens equal the plain greedy tokens")
                return
            lg = ref_logits[part]
            top = float(lg[ref_toks[part]])
            ulp = 2.0 ** (torch.frexp(torch.tensor(top)).exponent.item() - 8)
            gap = (top - float(lg[toks[part]])) / ulp
            log(f"{tag} parts from the plain greedy tokens at token {part}: plain "
                f"{ref_toks[part]}, speculative {toks[part]}, its plain logit {gap:.2f} bf16 "
                f"ulps below the top one {top:.3f} (near-tie tolerance {TIE_ULPS} ulps)")
            check(gap <= TIE_ULPS, f"{tag} greedy tokens part from the plain ones at {part} "
                  f"with a gap of {gap:.2f} bf16 ulps")

        t = Engine(params, cfgm, batch_size=1, max_seq=1024)
        ref_first, ref_toks, ref_logits = greedy_ref(t, prompt, n)
        check(ref_toks == [int(x) for x in plain["tokens"][0]],
              "spec runs: the decode_one loop's greedy tokens differ from the graph loop's")
        # the verify step over the plain tokens (teacher-forced) against the
        # decode steps' logits, position by position: T = 5 (K1 at 5 rows,
        # the round's step at k = 4) and T = 9 (K2: bf16-rounded weights)
        for T in (5, 9):
            t.reset()
            t.prefill(prompt)
            wp = int(t.seq_len[0])
            x = torch.tensor([[ref_first] + ref_toks[:T - 1]], device=dev)
            v = t._step(x, t._dev_i32([wp]), T, kv_cap=t._kv_cap(wp + T))[0].float().cpu()
            diff = [float((v[i] - torch.from_numpy(ref_logits[i])).abs().max()) for i in range(T)]
            same = sum(int(v[i].argmax()) == ref_toks[i] for i in range(T))
            log(f"[8b spec] the T={T} verify step over the plain tokens against the decode "
                f"steps: max |logit difference| by position {[round(d, 3) for d in diff]} (max "
                f"|logit| {float(np.abs(ref_logits[0]).max()):.3f}); argmax agrees at {same} of "
                f"{T}")
        spec_named = {}
        for name, n_l in (("full-depth self-draft", cfgm.n_layer), ("4-layer self-draft", 4)):
            tag, k = f"[8b spec on device, {name}, k 4]", 4
            d = (Engine(params, cfgm, batch_size=1, max_seq=1024) if n_l == cfgm.n_layer else
                 Engine(truncated_draft_params(params, n_l),
                        dataclasses.replace(cfgm, n_layer=n_l), batch_size=1, max_seq=1024))
            sp = OnDeviceSpeculative(t, d, k=k)
            for counted in (False, True):  # the first call captures the round's graph
                t.reset()
                d.reset()
                first = int(t.prefill(prompt).argmax())
                d.prefill(prompt)
                torch.cuda.synchronize()
                build.reset_launches()
                t1 = time.perf_counter()
                toks, st = sp.generate_greedy(first, n)
                dt = time.perf_counter() - t1
            launches = {kk: v for kk, v in build.LAUNCHES.items() if v}
            (cap_key, (_, captured)), = sp.graphs.items()
            log(f"{tag} {n} tokens in {dt:.3f}s: {dt / n * 1e3:.3f} ms/token against the plain "
                f"graph's {plain_ms:.3f}; {st['rounds']} rounds, accept rate "
                f"{st['accept_rate']:.3f} ({st['accepted']} of {st['drafted']}); {sp.host_reads} "
                f"host reads in the call; lengths {int(t.seq_len[0])}, {int(d.seq_len[0])}; "
                f"{card}")
            log(f"{tag} the round's graph (t_cap, d_cap) {cap_key}: {sum(captured.values())} "
                f"launches ({json.dumps(captured)}) x {sp.replays} replays; the call's launches "
                f"{json.dumps(launches)}")
            if n_l == cfgm.n_layer:
                spec_named["8b spec on device"] = {"total": dict(build.LAUNCHES)}
            check(launches == {kk: v * sp.replays for kk, v in captured.items()}
                  and sp.replays == st["rounds"] and captured.get("qmv")
                  and captured.get("flash_decode_dense") and captured.get("flash_prefill"),
                  f"{tag} launches {launches} are not the captured {captured} x {sp.replays}")
            check(PROMPT_LEN + n <= int(t.seq_len[0]) <= PROMPT_LEN + n + k
                  and int(d.seq_len[0]) == int(t.seq_len[0]),
                  f"{tag} lengths {t.seq_len} {d.seq_len}")
            agree(tag, toks, ref_toks, ref_logits)
            del d, sp
        # the host-driven rounds with a draft of Llama-3.2-1B's shape
        dcfg = llama3_2_1b_config()
        dparams = make_synthetic_params(dcfg, seed=1, ftype="Q4_K_M")
        d = Engine(dparams, dcfg, batch_size=1, max_seq=1024)
        tag = "[8b spec host, Llama-3.2-1B draft]"
        t.reset()
        d.reset()
        build.reset_launches()
        t1 = time.perf_counter()
        toks, st = SpeculativeDecoder(t, d).generate(prompt, n + 1)
        dt = time.perf_counter() - t1
        log(f"{tag} greedy, {n + 1} tokens (prefill included) in {dt:.3f}s: "
            f"{dt / (n + 1) * 1e3:.3f} ms/token against the plain graph's {plain_ms:.3f}; "
            f"{st['rounds']} rounds, {st['drafted']} drafted, {st['accepted']} accepted; "
            f"launches {json.dumps({kk: v for kk, v in build.LAUNCHES.items() if v})}; {card}")
        check(all(build.LAUNCHES[kk] for kk in ("qmv", "qgemm", *dense_attn)),
              f"{tag} launches {build.LAUNCHES}: not K1, K2, K4 and K5")
        spec_named["8b spec host"] = {"total": dict(build.LAUNCHES)}
        check(toks[0] == ref_first, f"{tag} first token {toks[0]}, not the prefill's {ref_first}")
        agree(tag, toks[1:], ref_toks, ref_logits)
        drawn = []
        for _ in range(2):
            t.reset()
            d.reset()
            chain = SamplerChain(SamplerParams(seed=1234), n_vocab=Vm)
            t1 = time.perf_counter()
            got, st = SpeculativeDecoder(t, d).generate(prompt, 32, sampler=chain)
            drawn.append(got)
            log(f"{tag} seeded sampling (seed 1234, the CLI's defaults), 32 tokens in "
                f"{time.perf_counter() - t1:.3f}s, {st}: {got[:12]}")
        check(drawn[0] == drawn[1], f"{tag} the seeded runs drew {drawn[0]} and {drawn[1]}")
        # a state round trip: the continuation after restore is the uninterrupted one
        with tempfile.TemporaryDirectory() as tmp:
            for kv in ("dense", "q8_0"):
                tag = f"[8b state, kv {kv}]"
                a = Engine(params, cfgm, batch_size=1, max_seq=1024, kv_type=kv)
                build.reset_launches()
                first = int(a.prefill(prompt).argmax())
                path = os.path.join(tmp, f"{kv}.state")
                t1 = time.perf_counter()
                save_row_state(a, path, tokens=prompt)
                t_save = time.perf_counter() - t1
                want = a.decode_greedy_tokens([first], 32)
                b = Engine(params, cfgm, batch_size=1, max_seq=1024, kv_type=kv)
                t1 = time.perf_counter()
                back = load_row_state(b, path)
                t_load = time.perf_counter() - t1
                n_back = int(b.seq_len[0])
                got = b.decode_greedy_tokens([first], 32)
                used = {kk: v for kk, v in build.LAUNCHES.items() if v}
                log(f"{tag} {os.path.getsize(path) / 1e6:.3f} MB saved in {t_save * 1e3:.1f} ms, "
                    f"restored in {t_load * 1e3:.1f} ms; the 32 tokens after restore equal the "
                    f"uninterrupted ones: {bool((got == want).all())}; launches {json.dumps(used)}")
                check(back == prompt and n_back == PROMPT_LEN
                      and bool((got == want).all()),
                      f"{tag} the restored row continues otherwise: {got[0, :8]} {want[0, :8]}")
                attn = quant_attn if kv == "q8_0" else dense_attn
                check(all(used.get(kk) for kk in ("qmv", "qgemm", *attn)),
                      f"{tag} launches {used}: not the path's kernels")
                del a, b
            # the server with -md, then slot save/restore
            tag = "[8b server -md]"
            vocab = synthetic_vocab(Vm)
            rng = np.random.default_rng(SEED + 23)
            prompts = [rng.integers(256, 128000, size=PROMPT_LEN).tolist() for _ in range(2)]
            refs = []
            for ids in prompts:
                t.reset()
                refs.append(greedy_ref(t, ids, 32))
            del t
            torch.cuda.empty_cache()
            ctx, httpd = serve(Model(cfgm, params, vocab, None), host="127.0.0.1", port=0,
                               n_slots=2, ctx_size=1024, draft_model=Model(dcfg, dparams, vocab,
                                                                           None))
            th = threading.Thread(target=httpd.serve_forever, daemon=True)
            th.start()
            url = f"http://127.0.0.1:{httpd.server_address[1]}"
            try:
                bodies = [{"prompt": ids, "n_predict": 33, "temperature": 0.0, "ignore_eos": True,
                           "return_tokens": True} for ids in prompts]
                out, wall = post_all(url, bodies)
                for i, (r, (rf, rt, rl)) in enumerate(zip(out, refs)):
                    tm = r["timings"]
                    log(f"{tag} request {i}: {r['tokens_predicted']} tokens at "
                        f"{tm['predicted_ms'] / r['tokens_predicted']:.3f} ms/token, drafted "
                        f"{tm.get('draft_n')}, accepted {tm.get('draft_n_accepted')}; {card}")
                    check(r["tokens"][0] == rf, f"{tag} request {i}: first token "
                          f"{r['tokens'][0]}, not the prefill's {rf}")
                    agree(f"{tag} request {i}", r["tokens"][1:], rt, rl)
                saved = http_post(url + "/slots/0?action=save", {"filename": "slot0.bin"})
                restored = http_post(url + "/slots/1?action=restore", {"filename": "slot0.bin"})
                erased = http_post(url + "/slots/1?action=erase", {})
                log(f"{tag} slot 0 saved {saved}; restored into slot 1 {restored}; {erased}")
                check(saved["n_saved"] == restored["n_restored"] >= PROMPT_LEN
                      and erased["n_erased"] == 1 and int(ctx.engine.seq_len[1]) == 0,
                      f"{tag} slot save/restore: {saved} {restored} {erased}")
            finally:
                httpd.shutdown()
                httpd.server_close()
                ctx.stop()
                th.join(timeout=60)
            check(not th.is_alive() and not ctx.thread.is_alive(), f"{tag} server threads run on")
        del d, dparams, ctx
        torch.cuda.empty_cache()
        log(f"[8b spec and state] wall time {time.perf_counter() - t_phase:.1f}s")
        return spec_named

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
            tensors = [params["tok_embd"], *([params["output"]] if "output" in params else []),
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
    spec_named = spec_runs(params, cfg, runs_8b["kv dense"])
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
    def batched_moe_run(tag, params, cfgm, B, n_tok=64):
        """A B-row decode of a MoE model through the graph: each step sends B
        x top-k (token, slot) rows through K10, at most 32 (the gather
        route's most: models/llama.py::_MOE_GATHER_MAX), so rows share
        experts; the kernel groups them by expert where there are at least
        twice as many rows as experts (qmm_id.gather_groups: Mixtral's 16 of
        8, launches counted as qmv_id_group), else takes a block per row
        (Qwen3-30B-A3B's 32 of 128, counted as qmv_id). B prompts of their
        own lengths, one a row; each row's greedy tokens must equal the same
        prompt's single-stream run. Returns the counted run's launches (the
        rows' prefills and the decode)."""
        t_run = time.perf_counter()
        Vm, rows = cfgm.n_vocab, B * cfgm.n_expert_used
        check(rows <= _MOE_GATHER_MAX, f"{tag}: {rows} rows a step are past the gather route")
        grouped = gather_groups(rows, cfgm.n_expert)
        kernel, other = ("qmv_id_group", "qmv_id") if grouped else ("qmv_id", "qmv_id_group")
        lengths = (PROMPT_LEN, 96, 64, 113, 80, 101, 72, 120)[:B]
        prompts = [[(j * 31337 + 977 * r) % Vm for j in range(n)]
                   for r, n in enumerate(lengths)]
        single = []
        eng1 = Engine(params, cfgm, batch_size=1, max_seq=1024)
        for p in prompts:
            eng1.reset()
            first = int(eng1.prefill(p).argmax())
            single.append([first, *eng1.decode_greedy_tokens([first], n_tok)[0].tolist()])
        del eng1
        eng = Engine(params, cfgm, batch_size=B, max_seq=1024)

        def run():
            eng.reset()
            firsts = [int(eng.prefill(p, row=r).argmax()) for r, p in enumerate(prompts)]
            t0 = time.perf_counter()
            toks = eng.decode_greedy_tokens(firsts, n_tok)
            return firsts, toks, time.perf_counter() - t0

        run()  # the graph's capture for the bucket (and its eager warm-up step)
        build.reset_launches()
        firsts, toks, dt = run()
        launches = dict(build.LAUNCHES)
        kv_cap = eng._kv_cap(max(map(len, prompts)) + n_tok + 1)
        captured = eng.decoder.graphs[kv_cap][1]
        for r in range(B):
            got = [firsts[r], *toks[r].tolist()]
            part = next((j for j, (a, b) in enumerate(zip(got, single[r])) if a != b), None)
            check(part is None, f"{tag} row {r}: greedy tokens part from the single-stream "
                  f"run at token {part}")
        products = 2 * cfgm.n_layer  # gate_up and down a layer
        check(captured.get(kernel, 0) == products and captured.get(other, 0) == 0,
              f"{tag}: {captured.get(kernel, 0)} {kernel} and {captured.get(other, 0)} {other} "
              f"launches a step (want one {kernel} a product, {products}, and no {other})")
        path = (*(k for k in moe_path if k != "qmv_id"), kernel)
        missing = [k for k in path if launches[k] == 0]
        stray = [k for k in launches if k not in path and launches[k] != 0]
        check(not missing and not stray, f"{tag}: kernels never launched {missing}, kernels of "
              f"another path launched {stray}")
        log(f"[{tag}] {cfgm.n_layer} layers, {B} rows (prompts of "
            f"{', '.join(str(len(p)) for p in prompts)} tokens), {n_tok} greedy steps through "
            f"the graph in {dt:.3f}s: {dt / n_tok * 1e3:.3f} ms a step ({B} tokens), "
            f"{B * n_tok / dt:.2f} tokens/s aggregate; {sum(captured.values())} launches a step "
            f"({json.dumps(captured)}): K10 at {rows} rows over {cfgm.n_expert} experts, "
            f"{'grouped by expert' if grouped else 'a block per row'} ({kernel}); every row's "
            f"tokens equal its single-stream run's; launches {json.dumps(launches)}; "
            f"{time.perf_counter() - t_run:.1f}s with the single-stream runs, on "
            f"{nvidia_smi_line()}")
        return {"total": launches, "ms": dt / n_tok * 1e3}

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
    # 8 rows a step over its first 4 layers: K10 groups 16 rows over 8 experts
    batch_runs = {MIXTRAL_BATCH_RUN: batched_moe_run(
        MIXTRAL_BATCH_RUN, {**params, "layers": params["layers"][:4]},
        mixtral_8x7b_config(n_layer=4), MIXTRAL_BATCH)}
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
    log(f"[phase 5] wall time after the presets and the 70B {time.perf_counter() - t5:.1f}s")

    def family_serving_run(tag, params, cfgm, ring):
        """A family model through the port's server on the card: 4 slots,
        ctx 4096, 4 greedy requests at once from --seed (prompts of 712, 300,
        612 and 1200 tokens), then a fifth. With `ring` (Gemma-3-12B, window
        1024: the ring), requests 0, 2 and 4 share a 512-token prefix, which
        the prefix rule routes to request 0's slot; a ring row is reused
        whole or prefilled anew, so no request reuses a prefix (cache_n 0),
        and context shift is off on a ring. Without (Phi-2), no prompt
        shares another's prefix, so none is reused either. Each request's
        tokens are those of one stream through an engine of the server's 4
        rows, fed on one row the chunks the slot is fed while the others idle
        (a B-row decode picks K4's split count by B, so a batch-of-one
        engine sums the attention of a deep row in another order, and a
        synthetic Phi-2 at full depth amplifies that past a tie: run C17-4),
        or part from them at a top-2 tie. Returns the launches."""
        from llamacog_tpu_torch.models.loader import Model
        from llamacog_tpu_torch.server.server import PREFILL_CHUNK
        from llamacog_tpu_torch.utils.synthetic import synthetic_vocab

        t_phase, n_tok = time.perf_counter(), 32
        model = Model(cfgm, params, synthetic_vocab(cfgm.n_vocab), None)
        rng = np.random.default_rng(SEED + 15)
        top = min(128000, cfgm.n_vocab - 10)  # the synthetic vocab's plain tokens

        def draw(n):
            return rng.integers(256, top, size=n).tolist()

        prefix = draw(512)
        lead = (lambda: prefix) if ring else (lambda: draw(512))
        prompts = [lead() + draw(200), draw(300), lead() + draw(100), draw(1200),
                   lead() + draw(150)]
        ref = []
        eng1 = Engine(params, cfgm, batch_size=4, max_seq=4096)
        check(eng1.ring == ring, f"{tag}: a 4096-token context keeps a ring: {eng1.ring}")
        one = np.array([True, False, False, False])
        for p in prompts:
            eng1.reset()
            for off in range(0, len(p), PREFILL_CHUNK):
                logits = eng1.prefill(p[off:off + PREFILL_CHUNK], row=0)
            toks, top2 = [], []
            for j in range(n_tok):
                lt = logits.reshape(-1).copy()
                first = int(np.argmax(lt))
                top1 = float(lt[first])
                lt[first] = -np.inf
                toks.append(first)
                top2.append((top1, float(lt.max())))
                if j + 1 < n_tok:
                    logits = eng1.decode_one([first, 0, 0, 0], active=one)[0]
            ref.append((toks, top2))
        del eng1
        torch.cuda.empty_cache()
        bodies = [{"prompt": p, "n_predict": n_tok, "ignore_eos": True, "return_tokens": True,
                   "temperature": 0.0} for p in prompts]

        def requests(url):
            first, wall = post_all(url, bodies[:4])
            again, _ = post_all(url, bodies[4:])
            return first + again, wall

        (out, wall), launches, metrics, peak = served(tag, model, requests, n_slots=4,
                                                      ctx_size=4096)
        finals = [r[-1] if isinstance(r, list) else r for r in out]
        for i, (f, (want, top2)) in enumerate(zip(finals, ref)):
            got, t = f["tokens"], f["timings"]
            check(t["cache_n"] == 0 and len(got) == n_tok,
                  f"{tag} request {i}: {t['cache_n']} prompt tokens reused, {len(got)} tokens")
            part = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), None)
            gap = None
            if part is not None:
                top1, second = top2[part]
                gap = (top1 - second) / 2.0 ** (torch.frexp(torch.tensor(top1)).exponent.item()
                                                - 8)
                check(gap <= TIE_ULPS, f"{tag} request {i}: greedy tokens part from the one-row "
                      f"stream at {part} with a top-2 gap of {gap:.2f} ulps")
            log(f"[{tag}] request {i} ({len(prompts[i])} prompt tokens, "
                f"{t['cache_n']} reused): TTFT {t['prompt_ms']:.2f} ms from admission, "
                f"{t['predicted_ms'] / n_tok:.3f} ms/token; "
                + ("its tokens equal the one-row stream's" if part is None else
                   f"parts from the one-row stream at token {part} at a tie ({gap:.2f} ulps)"))
        check(metrics.get("context_shifts_total", 0) == 0
              and metrics.get("prompt_tokens_cached_total", 0) == 0,
              f"{tag}: context shifts or prefix reuse: {metrics}")
        log(f"[{tag}] 4 requests at once in {wall:.3f}s, then one "
            + ("sharing request 0's 512-token prefix, prefilled anew in its slot"
               if ring else "more") + "; no prefix reused, no context shift; peak device "
            f"memory {peak / 2**30:.2f} GiB on {nvidia_smi_line()}; "
            f"{time.perf_counter() - t_phase:.1f}s")
        return {"total": launches}

    # the Qwen and Gemma families (Q4_K_M; a 128-token prompt and 64 greedy
    # tokens through the graph unless named): at full depth Qwen2.5-7B,
    # Qwen3-30B-A3B (also a 512-token prompt, 16 tokens: K11 over several
    # tiles an expert, in one 512-token chunk, the engine's step for 128
    # experts), Gemma-3-12B (a 1536-token prompt in two 768-token chunks at
    # max_seq 2048: the ring wraps) and Qwen2.5-0.5B (its padded 32-weight-
    # block kinds); at 4 layers Qwen3-8B, Gemma-2-9B (max_seq 8192: the
    # ring; the full store with kv bf16, K4 and K5 with the window; q8_0,
    # K6 and K7 with it) and Qwen2-57B-A14B
    quant_path = ("qmv", "qgemm", *quant_attn)
    moe_quant = (*quant_path, *moe_kernels)
    family_runs = {}
    t_fam = time.perf_counter()
    for model, cfgf, runs_f in (
            ("qwen2.5-7b", qwen2_5_7b_config(), [
                ("kv dense", "dense", {}, PROMPT_LEN, exact_path, 1024, 64)]),
            ("qwen3-30b-a3b", qwen3_30b_a3b_config(), [
                ("kv dense", "dense", {}, PROMPT_LEN, moe_path, 1024, 64),
                ("512", "dense", {}, 512, moe_path, 1024, 16)]),
            ("gemma3-12b", gemma3_12b_config(), [
                ("kv dense", "dense", {}, 1536, exact_path, 2048, 64, 768)]),
            ("qwen2.5-0.5b", qwen2_5_0_5b_config(), [
                ("kv dense", "dense", {}, PROMPT_LEN, exact_path, 1024, 64)]),
            ("qwen3-8b", qwen3_8b_config(n_layer=4), [
                ("kv dense", "dense", {}, PROMPT_LEN, exact_path, 1024, 64)]),
            ("gemma2-9b", gemma2_9b_config(n_layer=4), [
                ("kv dense", "dense", {}, PROMPT_LEN, exact_path, 8192, 64),
                ("kv bf16", "bf16", {}, PROMPT_LEN, exact_path, 8192, 64),
                ("kv q8_0", "q8_0", {}, PROMPT_LEN, quant_path, 8192, 64)]),
            ("qwen2-57b-a14b", qwen2_57b_a14b_config(n_layer=4), [
                ("kv dense", "dense", {}, PROMPT_LEN, moe_path, 1024, 64)]),
            # DeepSeek-V2-Lite at full depth: MLA (K5/K7's 192/128 tiles, K4/K6
            # at Dk != Dv), the dense lead layer's K-10944 ffn_down, 26 MoE
            # layers of 64 experts top 6 beside 2 shared ones; dense and q8_0,
            # and a 512-token prompt in one step (K11 over 3072 rows)
            ("deepseek-v2-lite", deepseek_v2_lite_config(), [
                ("kv dense", "dense", {}, PROMPT_LEN, moe_path, 1024, 64),
                ("kv q8_0", "q8_0", {}, PROMPT_LEN, moe_quant, 1024, 64),
                ("512", "dense", {}, 512, moe_path, 1024, 16)]),
            # the q LoRA and 160 experts (routed scale 16): the dense lead
            # layer and one MoE layer
            ("deepseek-v2", deepseek_v2_config(n_layer=2), [
                ("kv dense", "dense", {}, PROMPT_LEN, moe_path, 1024, 64)]),
            # D 96, fused qkv and gate_up, the short rope factors (max_seq
            # 1024 within the original 4096)
            ("phi3.5-mini", phi3_5_mini_config(), [
                ("kv dense", "dense", {}, PROMPT_LEN, exact_path, 1024, 64),
                ("kv q8_0", "q8_0", {}, PROMPT_LEN, quant_path, 1024, 64)]),
            ("command-r-v01", command_r_v01_config(n_layer=4), [
                ("kv dense", "dense", {}, PROMPT_LEN, exact_path, 1024, 64)]),
            # past the 4096 window: a 4352-token prompt in 2048-token chunks at
            # max_seq 8192 (the ring of layers 0-2 wraps; layer 3 global, NoPE)
            ("command-r7b", command_r7b_config(n_layer=4), [
                ("kv dense", "dense", {}, 4352, exact_path, 8192, 64, 2048)]),
            ("gemma-7b", gemma_7b_config(n_layer=4), [
                ("kv dense", "dense", {}, PROMPT_LEN, exact_path, 1024, 64)])):
        params = build_params(model, cfgf, "Q4_K_M")
        got = main_path_runs(model, params, cfgf, runs_f)
        for (name, kv_type, _, prompt_len, _, max_seq, n_tok, *chunk) in runs_f:
            key = model if name == "kv dense" else f"{model} {name}"
            r = family_runs[key] = got[name]
            # one prefill attention launch a layer and chunk, one decode one a
            # layer and token; a ring's window layers read it through the
            # masked attention, so K4/K5 run on the global layers alone
            ring = kv_type == "dense" and 0 < cfgf.sliding_window < max_seq \
                and cfgf.swa_pattern > 1
            n_att = sum(1 for il in range(cfgf.n_layer) if not (ring and cfgf.is_swa(il)))
            chunks = -(-prompt_len // (chunk[0] if chunk else prompt_len))
            pre, dec = (("flash_prefill_quant", "flash_decode_quant") if kv_type == "q8_0"
                        else ("flash_prefill", "flash_decode_dense"))
            check(r["prefill"][pre] == chunks * n_att and r["decode"][dec] == n_tok * n_att,
                  f"{key}: prefill {pre} {r['prefill'][pre]} (want {chunks * n_att}), decode "
                  f"{dec} {r['decode'][dec]} (want {n_tok * n_att})")
        log(f"[{model}] {cfgf.n_layer} layers, weight-stream bound "
            f"{sum_wire_bytes(params, cfgf) / HBM_BYTES_PER_S * 1e3:.3f} ms/token "
            f"({sum_wire_bytes(params, cfgf) / 1e9:.3f} GB a token) on {nvidia_smi_line()}")
        if "512" in got:  # one chunk: gate_up and down a MoE layer
            got512 = got["512"]["prefill"]["qgemm_id"]
            want512 = 2 * (cfgf.n_layer - cfgf.n_layer_dense_lead)
            check(got512 == want512, f"{model} 512 run: prefill qgemm_id {got512} (want "
                  f"{want512}: one 512-token chunk)")
        if model == "qwen3-30b-a3b":  # its first 4 layers, 4 rows a step
            batch_runs["qwen3-30b-a3b batch 4"] = batched_moe_run(
                "qwen3-30b-a3b batch 4", {**params, "layers": params["layers"][:4]},
                qwen3_30b_a3b_config(n_layer=4), SERVING_SLOTS)
        if model == "gemma3-12b":
            family_runs["gemma3-12b serving"] = family_serving_run("gemma3-12b serving", params,
                                                                   cfgf, ring=True)
        del params
        torch.cuda.empty_cache()
    log(f"[families] runs {time.perf_counter() - t_fam:.1f}s")
    # the layer-norm families in Q4_K_M, a 128-token prompt and 64 greedy
    # tokens through the graph: Phi-2 at full depth with the dense cache
    # (K4/K5 at D 80) and q8_0 (the masked path at D 80, the JAX route: no
    # K6/K7), then its serving run on 4 slots; Falcon-7B at full depth, dense
    # (K4/K5 at rep 71) and q8_0 (K6/K7 at rep 71), and a 512-token prompt;
    # GPT-2 (learned positions, max_seq 1024: its table) and StableLM-2-1.6B
    # at full depth; StarCoder2-7B, StarCoderBase-7B (dense and q8_0: rep
    # 32), Pythia-6.9B and GPT-J-6B at 4 layers; Falcon-40B at 2
    t_ln = time.perf_counter()
    for model, cfgf, runs_f in (
            ("phi2", phi2_config(), [
                ("kv dense", "dense", {}, PROMPT_LEN, exact_path, 1024, 64),
                ("kv q8_0", "q8_0", {}, PROMPT_LEN, ("qmv", "qgemm"), 1024, 64)]),
            ("falcon-7b", falcon_7b_config(), [
                ("kv dense", "dense", {}, PROMPT_LEN, exact_path, 1024, 64),
                ("kv q8_0", "q8_0", {}, PROMPT_LEN, quant_path, 1024, 64),
                ("512", "dense", {}, 512, exact_path, 1024, 64)]),
            ("gpt2", gpt2_config(), [
                ("kv dense", "dense", {}, PROMPT_LEN, exact_path, 1024, 64)]),
            ("stablelm-2-1.6b", stablelm2_1_6b_config(), [
                ("kv dense", "dense", {}, PROMPT_LEN, exact_path, 1024, 64)]),
            ("starcoder2-7b", starcoder2_7b_config(n_layer=4), [
                ("kv dense", "dense", {}, PROMPT_LEN, exact_path, 1024, 64)]),
            ("starcoderbase-7b", starcoderbase_7b_config(n_layer=4), [
                ("kv dense", "dense", {}, PROMPT_LEN, exact_path, 1024, 64),
                ("kv q8_0", "q8_0", {}, PROMPT_LEN, quant_path, 1024, 64)]),
            ("pythia-6.9b", pythia_6_9b_config(n_layer=4), [
                ("kv dense", "dense", {}, PROMPT_LEN, exact_path, 1024, 64)]),
            ("gpt-j-6b", gptj_6b_config(n_layer=4), [
                ("kv dense", "dense", {}, PROMPT_LEN, exact_path, 1024, 64)]),
            ("falcon-40b", falcon_40b_config(n_layer=2), [
                ("kv dense", "dense", {}, PROMPT_LEN, exact_path, 1024, 64)])):
        params = build_params(model, cfgf, "Q4_K_M")
        got = main_path_runs(model, params, cfgf, runs_f)
        masked_q8 = not flash_q8_mod.quant_heads_supported(cfgf)
        for (name, kv_type, _, prompt_len, _, max_seq, n_tok, *chunk) in runs_f:
            key = model if name == "kv dense" else f"{model} {name}"
            r = family_runs[key] = got[name]
            # one prefill attention launch a layer, one decode one a layer and
            # token: K5/K4 on the dense cache, K7/K6 on q8_0; none at all on
            # q8_0 at a head dim that 32 does not divide (Phi-2: the masked
            # path, the JAX route)
            L_f = cfgf.n_layer
            pre, dec = (("flash_prefill_quant", "flash_decode_quant") if kv_type == "q8_0"
                        else ("flash_prefill", "flash_decode_dense"))
            want_pre, want_dec = (0, 0) if kv_type == "q8_0" and masked_q8 else (L_f, n_tok * L_f)
            attn = {k: r["total"][k] for k in (*dense_attn, *quant_attn, "flash_decode")}
            check(r["prefill"][pre] == want_pre and r["decode"][dec] == want_dec
                  and sum(attn.values()) == want_pre + want_dec,
                  f"{key}: prefill {pre} {r['prefill'][pre]} (want {want_pre}), decode {dec} "
                  f"{r['decode'][dec]} (want {want_dec}); attention launches {attn}")
            log(f"[{key}] attention launches {json.dumps(attn)}: "
                + ("the masked path, no attention kernel (the JAX route at head dim "
                   f"{cfgf.head_dim_k})" if want_pre == 0 else f"{pre} and {dec}"))
        log(f"[{model}] {cfgf.n_layer} layers, weight-stream bound "
            f"{sum_wire_bytes(params, cfgf) / HBM_BYTES_PER_S * 1e3:.3f} ms/token "
            f"({sum_wire_bytes(params, cfgf) / 1e9:.3f} GB a token) on {nvidia_smi_line()}")
        if model == "phi2":
            family_runs["phi2 serving"] = family_serving_run("phi2 serving", params, cfgf,
                                                             ring=False)
        del params
        torch.cuda.empty_cache()
    log(f"[layer-norm families] runs {time.perf_counter() - t_ln:.1f}s")
    # Llama 4 and the OLMo and scaled families in Q4_K_M, a 128-token prompt
    # and 64 greedy tokens through the graph: Granite-3.1-8B at full depth,
    # dense and q8_0; OLMoE-1B-7B at full depth; OLMo-2-7B, OLMo-7B,
    # Granite-3.1-3B-A800M and MiniCPM-2B at 4 layers; then, with the others
    # freed, Llama-4-Scout-17B-16E at full depth (48 layers, ~60 GiB of wire
    # blocks): chunked attention on every layer through the masked path (no
    # attention kernel), NoPE layers 3, 7, ..., K10 at one pair a token and
    # K11 over 16 experts, the 202048-row head
    def family_path_runs(model, params, cfgf, runs_f, got):
        """Record each run of main_path_runs in family_runs and check its
        attention launches: one prefill attention launch a layer, one decode
        one a layer and token, and none at all for a chunked or ALiBi model
        (masked_only: the masked path); log its decode ms/token beside the
        weight-stream bound, TTFT, peak memory and launches a token."""
        masked = flash_q8_mod.masked_only(cfgf)
        bound = sum_wire_bytes(params, cfgf) / HBM_BYTES_PER_S * 1e3
        for (name, kv_type, _, prompt_len, _, max_seq, n_tok, *chunk) in runs_f:
            key = model if name == "kv dense" else f"{model} {name}"
            r = family_runs[key] = got[name]
            L_f = cfgf.n_layer
            pre, dec = (("flash_prefill_quant", "flash_decode_quant") if kv_type == "q8_0"
                        else ("flash_prefill", "flash_decode_dense"))
            want_pre, want_dec = (0, 0) if masked else (L_f, n_tok * L_f)
            attn = {k: r["total"][k] for k in (*dense_attn, *quant_attn, "flash_decode")}
            check(r["prefill"][pre] == want_pre and r["decode"][dec] == want_dec
                  and sum(attn.values()) == want_pre + want_dec,
                  f"{key}: prefill {pre} {r['prefill'][pre]} (want {want_pre}), decode {dec} "
                  f"{r['decode'][dec]} (want {want_dec}); attention launches {attn}")
            log(f"[{key}] {L_f} layers: decode {r['ms']:.3f} ms/token (bound {bound:.3f}), "
                f"TTFT {statistics.median(r['ttft']) * 1e3:.2f} ms, peak device memory "
                f"{r['peak'] / 2**30:.2f} GiB, {sum(r['decode'].values()) / n_tok:.0f} "
                f"hand-written kernel launches a token; attention launches {json.dumps(attn)}"
                + (" (the masked path)" if masked else "")
                + f" on {nvidia_smi_line()}")

    def graph_equals_eager(model, params, cfgm, n_steps=4):
        """Two engines at the same state: each decode step's logits replayed
        from the captured graph (decode_one) equal the same step's forward
        called eagerly, bit for bit (BLOOM's ALiBi distances and masks built
        on the device from the step's write offset buffer at every replay;
        Arctic's dense FFN and MoE branch in every layer)."""
        engs = [Engine(params, cfgm, batch_size=1, max_seq=1024) for _ in range(2)]
        prompt = [(j * 31337) % cfgm.n_vocab for j in range(PROMPT_LEN)]
        for e in engs:
            e.prefill(prompt)
        graph, eager = engs
        tok = 5
        for i in range(n_steps):
            n = int(eager.seq_len[0])
            want = eager._step(torch.tensor([[tok]], device=dev), eager._dev_i32([n]), 1,
                               kv_cap=eager._kv_cap(n + 1))[0, 0].cpu()
            eager.seq_len[0] += 1
            got = torch.from_numpy(graph.decode_one([tok])[0])
            check(torch.equal(got, want), f"{model}: decode step {i}: the graph's logits "
                  f"differ from the eager step's by {float((got - want).abs().max()):.3e}")
            tok = int(want.argmax())
        log(f"[{model}] {n_steps} decode steps: the graph's logits equal the eager step's bit "
            f"for bit")
        del engs, graph, eager
        torch.cuda.empty_cache()

    t_new = time.perf_counter()
    for model, cfgf, runs_f in (
            ("granite-3.1-8b", granite_3_1_8b_config(), [
                ("kv dense", "dense", {}, PROMPT_LEN, exact_path, 1024, 64),
                ("kv q8_0", "q8_0", {}, PROMPT_LEN, quant_path, 1024, 64)]),
            ("olmoe-1b-7b", olmoe_1b_7b_config(), [
                ("kv dense", "dense", {}, PROMPT_LEN, moe_path, 1024, 64)]),
            ("olmo2-7b", olmo2_7b_config(n_layer=4), [
                ("kv dense", "dense", {}, PROMPT_LEN, exact_path, 1024, 64)]),
            ("olmo-7b", olmo_7b_config(n_layer=4), [
                ("kv dense", "dense", {}, PROMPT_LEN, exact_path, 1024, 64)]),
            ("granite-3.1-3b-a800m", granite_3_1_3b_a800m_config(n_layer=4), [
                ("kv dense", "dense", {}, PROMPT_LEN, moe_path, 1024, 64)]),
            ("minicpm-2b", minicpm_2b_config(n_layer=4), [
                ("kv dense", "dense", {}, PROMPT_LEN, exact_path, 1024, 64)]),
            ("llama4-scout", llama4_scout_config(), [
                ("kv dense", "dense", {}, PROMPT_LEN, ("qmv", "qgemm", *moe_kernels), 1024,
                 64)])):
        params = build_params(model, cfgf, "Q4_K_M")
        got = main_path_runs(model, params, cfgf, runs_f)
        family_path_runs(model, params, cfgf, runs_f, got)
        del params
        torch.cuda.empty_cache()
    log(f"[llama4, olmo and scaled families] runs {time.perf_counter() - t_new:.1f}s")
    # the ALiBi families, the clones and relu^2 in Q4_K_M, a 128-token prompt
    # and 64 greedy tokens through the graph: BLOOM-7B1 at full depth (30
    # layers, its tied 250880-row head; dense and q8_0: every layer through
    # the masked path with its slopes and distances, no attention kernel,
    # checked; the graph's logits held bit for bit against the eager
    # step's), then MPT-7B, Jais-13B (its F16 ffn_down a dense product) and
    # Refact-1.6B (the masked path too), Orion-14B, CodeShell-7B, Qwen-7B,
    # PLaMo-13B and Minitron-4B (K4/K5) at 4 layers. The four flag-identical
    # clones (xverse, baichuan, internlm2, exaone) and AFM-4.5B run phase 4
    # alone: their runs here would repeat the 8B's path
    t_alibi = time.perf_counter()
    masked_path = ("qmv", "qgemm")
    for model, cfgf, runs_f in (
            ("bloom-7b1", bloom_7b1_config(), [
                ("kv dense", "dense", {}, PROMPT_LEN, masked_path, 1024, 64),
                ("kv q8_0", "q8_0", {}, PROMPT_LEN, masked_path, 1024, 64)]),
            ("mpt-7b", mpt_7b_config(n_layer=4), [
                ("kv dense", "dense", {}, PROMPT_LEN, masked_path, 1024, 64)]),
            ("jais-13b", jais_13b_config(n_layer=4), [
                ("kv dense", "dense", {}, PROMPT_LEN, masked_path, 1024, 64)]),
            ("refact-1.6b", refact_1_6b_config(n_layer=4), [
                ("kv dense", "dense", {}, PROMPT_LEN, masked_path, 1024, 64)]),
            ("orion-14b", orion_14b_config(n_layer=4), [
                ("kv dense", "dense", {}, PROMPT_LEN, exact_path, 1024, 64)]),
            ("codeshell-7b", codeshell_7b_config(n_layer=4), [
                ("kv dense", "dense", {}, PROMPT_LEN, exact_path, 1024, 64)]),
            ("qwen-7b", qwen_7b_config(n_layer=4), [
                ("kv dense", "dense", {}, PROMPT_LEN, exact_path, 1024, 64)]),
            ("plamo-13b", plamo_13b_config(n_layer=4), [
                ("kv dense", "dense", {}, PROMPT_LEN, exact_path, 1024, 64)]),
            ("minitron-4b", minitron_4b_config(n_layer=4), [
                ("kv dense", "dense", {}, PROMPT_LEN, exact_path, 1024, 64)])):
        params = build_params(model, cfgf, "Q4_K_M")
        got = main_path_runs(model, params, cfgf, runs_f)
        family_path_runs(model, params, cfgf, runs_f, got)
        if model == "bloom-7b1":
            graph_equals_eager(model, params, cfgf)
        del params
        torch.cuda.empty_cache()
    log(f"[alibi families, clones and relu2] runs {time.perf_counter() - t_alibi:.1f}s")
    # the MoE variants in Q4_K_M, a 128-token prompt and 64 greedy tokens
    # through the graph: DeepSeek-MoE-16B at full depth (28 layers, ~11.2 GB
    # of wire blocks: the dense lead layer's K-10944 ffn_down, 27 MoE layers
    # of 64 experts top 6 beside 2 shared ones); dots.llm1, Ling-lite,
    # Phi-3.5-MoE, Grok-1, DBRX and Snowflake Arctic at 4 layers (Grok-1,
    # DBRX and Arctic do not fit on one card at full depth; Arctic's 4
    # layers of 128 experts hold ~33.4 GB); Arctic's replayed step's logits
    # held bit for bit against the eager step's (its two FFN branches a
    # layer)
    t_moe = time.perf_counter()
    for model, cfgf in (("deepseek-moe-16b", deepseek_moe_16b_config()),
                        ("dots1", dots1_config(n_layer=4)),
                        ("ling-lite", ling_lite_config(n_layer=4)),
                        ("phi3.5-moe", phi3_5_moe_config(n_layer=4)),
                        ("grok-1", grok_1_config(n_layer=4)),
                        ("dbrx", dbrx_config(n_layer=4)),
                        ("arctic", arctic_config(n_layer=4))):
        runs_f = [("kv dense", "dense", {}, PROMPT_LEN, moe_path, 1024, 64)]
        params = build_params(model, cfgf, "Q4_K_M")
        got = main_path_runs(model, params, cfgf, runs_f)
        family_path_runs(model, params, cfgf, runs_f, got)
        if model == "arctic":
            graph_equals_eager(model, params, cfgf)
        del params
        torch.cuda.empty_cache()
    log(f"[moe variants] runs {time.perf_counter() - t_moe:.1f}s")
    # the last decoders, a 128-token prompt and 64 greedy tokens through the
    # graph: GLM-4-9B-0414 in Q4_K_M at full depth (40 layers; K4/K5 at 16
    # query heads a kv head), OpenELM-3B in Q4_K_M at full depth (36 layers:
    # the masked path on every layer, no attention kernel, checked; its
    # replayed step's logits held bit for bit against the eager step's),
    # MiniCPM3-4B in Q4_K_M at full depth (62 layers; dense and q8_0: K4-K7
    # at K 96 / V 64) and BitNet b1.58-large in TQ2_0 and TQ1_0 at full
    # depth (24 layers)
    t_last = time.perf_counter()
    for model, cfgf, ftype, runs_f in (
            ("glm4-9b-0414", glm4_9b_0414_config(), "Q4_K_M", [
                ("kv dense", "dense", {}, PROMPT_LEN, exact_path, 1024, 64)]),
            ("openelm-3b", openelm_3b_config(), "Q4_K_M", [
                ("kv dense", "dense", {}, PROMPT_LEN, masked_path, 1024, 64)]),
            ("minicpm3-4b", minicpm3_4b_config(), "Q4_K_M", [
                ("kv dense", "dense", {}, PROMPT_LEN, exact_path, 1024, 64),
                ("kv q8_0", "q8_0", {}, PROMPT_LEN, quant_path, 1024, 64)]),
            ("bitnet TQ2_0", bitnet_b1_58_large_config(), "TQ2_0", [
                ("kv dense", "dense", {}, PROMPT_LEN, exact_path, 1024, 64)]),
            ("bitnet TQ1_0", bitnet_b1_58_large_config(), "TQ1_0", [
                ("kv dense", "dense", {}, PROMPT_LEN, exact_path, 1024, 64)])):
        params = build_params(model, cfgf, ftype)
        got = main_path_runs(model, params, cfgf, runs_f)
        family_path_runs(model, params, cfgf, runs_f, got)
        if model == "openelm-3b":
            graph_equals_eager(model, params, cfgf)
        del params
        torch.cuda.empty_cache()
    log(f"[last decoders] runs {time.perf_counter() - t_last:.1f}s")
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
                 "mixtral 512": runs_moe["kv dense 512"], **preset_runs, **serving, **rows_runs,
                 **batch_runs, **spec_named,
                 **family_runs}
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
    (the embedding table is gathered by row, not streamed; a tied one is
    the head, and streamed as such). A dense layer tensor counts its bytes
    as held: the norms and biases, and a product llama.cpp leaves F16
    (Jais-13B's ffn_down at K 13653, kept in the model dtype)."""
    from llamacog_tpu_torch.quant.wire import WireTensor

    total = wire_need(params.get("output", params["tok_embd"]))  # the tied table is the head
    for layer in params["layers"]:
        for v in layer.values():
            if not isinstance(v, WireTensor):
                total += v.numel() * v.element_size()
            elif len(v.shape) == 3:
                total += wire_need(v) * cfg.n_expert_used // cfg.n_expert
            else:
                total += wire_need(v)
    return total


def wire_need(w) -> int:
    """The wire bytes a product over w must read: its blocks, less the zero
    blocks that pad a 32-weight-block row to a whole 256-weight run."""
    return w.nbytes * w.shape[-1] // w.k_pad


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="smoke test of the PyTorch port on one GPU")
    ap.add_argument("--seed", type=int, default=SEED, help="seed of the serving run's prompts")
    SEED = ap.parse_args().seed
    sys.exit(main())
