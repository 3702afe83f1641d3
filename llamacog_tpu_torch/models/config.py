"""Model hyperparameters from GGUF metadata.

Key registry mirrors the reference (llama.cpp src/llama-arch.cpp LLM_KV_NAMES,
gguf-py/gguf/constants.py Keys).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any


@dataclass
class RopeConfig:
    dim: int = 0  # rotary dims (defaults to head_dim)
    freq_base: float = 10000.0
    scaling_type: str = "none"  # none | linear | yarn | longrope
    scaling_factor: float = 1.0
    orig_ctx_len: int = 0
    attn_factor: float = 1.0
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    yarn_log_mul: float = 0.0
    enabled: bool = True  # False for learned-position arches (gpt2 family)
    # ggml_rope mode 0 ("norm"): rotate interleaved pairs (2i, 2i+1) — gptj/
    # glm; default NeoX half-split pairs (i, i+dim/2)
    interleaved: bool = False
    # M-RoPE (qwen2vl): rotary-pair sectors per position component (t,h,w,e)
    sections: tuple = ()


@dataclass
class ModelConfig:
    arch: str
    n_vocab: int
    n_ctx_train: int
    n_embd: int
    n_layer: int
    n_head: int
    n_head_kv: int
    n_ff: int
    head_dim_k: int
    head_dim_v: int
    rms_norm_eps: float = 1e-5
    rope: RopeConfig = field(default_factory=RopeConfig)
    # MoE
    n_expert: int = 0
    n_expert_used: int = 0
    expert_gating_func: str = "softmax"  # softmax | sigmoid
    expert_weights_norm: bool = False
    expert_weights_scale: float = 1.0
    n_ff_exp: int = 0
    n_ff_shexp: int = 0
    n_expert_shared: int = 0
    # MLA / low-rank attention (deepseek2; llama-hparams.h n_lora_q/kv)
    n_lora_q: int = 0
    n_lora_kv: int = 0
    n_layer_dense_lead: int = 0  # deepseek: first K layers use dense FFN
    # SSM / recurrent (mamba; reference llama-hparams.h:115-121)
    ssm_d_conv: int = 0
    ssm_d_inner: int = 0
    ssm_d_state: int = 0
    ssm_dt_rank: int = 0
    ssm_dt_b_c_rms: bool = False
    # rwkv (llama.h LLM_KV_WKV_HEAD_SIZE / RESCALE_EVERY_N_LAYERS)
    wkv_head_size: int = 0
    rescale_every_n: int = 0
    # attention extras
    sliding_window: int = 0
    swa_pattern: int = 1  # every Nth layer is non-SWA (1 = no SWA)
    swa_type: str = "standard"  # standard | chunked (llama4 8k chunks)
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    # arch-specific graph features (reference: per-arch llm_build_* structs,
    # src/llama-model.cpp; defaults applied by _apply_arch_defaults below)
    embd_scale: float = 1.0  # gemma: sqrt(n_embd) input scaling
    attn_scale: float = 0.0  # 0 -> 1/sqrt(head_dim_k) (f_attention_scale)
    ffn_act: str = "silu"  # silu | gelu | gelu_quick | relu | relu2
    norm_type: str = "rms"  # rms | layer
    norm_eps: float = 1e-5  # layer-norm epsilon (f_norm_eps)
    parallel_residual: bool = False  # phi2/gptneox/command-r: attn+ffn share input
    post_norms: bool = False  # gemma2/3: attn_post_norm / ffn_post_norm
    post_norm_only: bool = False  # olmo2: no pre-norms, norm the branch outputs
    qk_norm_full: bool = False  # olmo2: q/k norm over the full projection
    qk_norm_layer: bool = False  # chameleon: per-head LayerNorm q/k ([H,D] w)
    nonparam_norms: bool = False  # olmo: LayerNorm with no weight/bias tensors
    # llama4 (llm_build_llama_iswa, llama-model.cpp:4847): NoPE layers every
    # Nth layer get a position-temperature Q scale instead of rope; roped
    # layers optionally L2-normalize q/k (Llama4TextL2Norm)
    n_no_rope_layer_step: int = 0
    use_kq_norm: bool = False
    use_attn_temp: bool = False
    n_attn_temp_floor_scale: int = 8192
    f_attn_temp_scale: float = 0.1
    moe_weight_before: bool = False  # llama4: gate weights scale expert INPUT
    logit_scale: float = 1.0  # command-r: multiplier; granite: divisor (see defaults)
    residual_scale: float = 1.0  # granite: scales attn/ffn branch outputs
    learned_pos_embd: bool = False  # gpt2/bert: position_embd.weight added
    causal: bool = True  # False for encoder models (bert)
    # nomic-bert-moe: layers with il % n == 1 use a (gateless) MoE FFN
    # (llama_hparams.moe_every_n_layers, src/llama-hparams.h:73)
    moe_every_n_layers: int = 0
    # ALiBi (bloom/mpt): scores += slope_h * -(pos_q - pos_k); slopes from
    # max_alibi_bias per ggml soft_max_ext semantics
    use_alibi: bool = False
    max_alibi_bias: float = 8.0
    attn_clamp: float = 0.0  # mpt/dbrx clamp_kqv: clip QKV activations
    # per-layer head counts (llama_hparams arrays, src/llama-hparams.h);
    # empty = uniform. Layers with 0 KV heads skip attention (Deci-style).
    n_head_arr: tuple = ()
    n_head_kv_arr: tuple = ()
    rope_freq_base_swa: float = 0.0  # gemma3: different rope base on SWA layers
    # misc
    tie_word_embeddings: bool = False
    metadata: dict[str, Any] = field(default_factory=dict)

    @property
    def kq_scale(self) -> float:
        return self.attn_scale if self.attn_scale > 0.0 else self.head_dim_k**-0.5

    @property
    def rope_swa(self) -> "RopeConfig":
        """Rope config for SWA layers (gemma3: plain 10k base, no scaling)."""
        if self.rope_freq_base_swa <= 0.0:
            return self.rope
        return RopeConfig(dim=self.rope.dim, freq_base=self.rope_freq_base_swa)

    @property
    def is_recurrent(self) -> bool:
        """SSM/recurrent-state model (mamba/rwkv families) — uses the
        recurrent memory module instead of a KV cache
        (llama-memory-recurrent.h:16)."""
        return self.ssm_d_inner > 0 or self.wkv_head_size > 0

    @property
    def n_gqa(self) -> int:
        return self.n_head // max(self.n_head_kv, 1)

    def n_head_at(self, il: int) -> int:
        return self.n_head_arr[il] if self.n_head_arr else self.n_head

    def n_head_kv_at(self, il: int) -> int:
        return self.n_head_kv_arr[il] if self.n_head_kv_arr else self.n_head_kv

    def is_swa(self, layer: int) -> bool:
        """Gemma-style interleaved SWA: layer is SWA unless (layer+1) % pattern == 0."""
        if self.sliding_window <= 0 or self.swa_pattern <= 1:
            return False
        return (layer + 1) % self.swa_pattern != 0

    @classmethod
    def from_metadata(cls, md: dict[str, Any]) -> "ModelConfig":
        arch = str(md["general.architecture"])

        def g(key: str, default=None):
            return md.get(f"{arch}.{key}", default)

        n_embd = int(g("embedding_length"))
        nh = g("attention.head_count", 0)
        if nh is None:
            nh = 0
        # per-layer head-count arrays (llama_hparams stores arrays,
        # src/llama-hparams.h): keep the array, use max for cache sizing
        n_head_arr = n_head_kv_arr = ()
        try:
            n_head = int(nh)
        except TypeError:
            n_head_arr = tuple(int(x) for x in nh)
            n_head = max(n_head_arr)
        hk = g("attention.head_count_kv", n_head)
        try:
            n_head_kv = int(hk)
        except TypeError:
            n_head_kv_arr = tuple(int(x) for x in hk)
            n_head_kv = max(n_head_kv_arr)
        head_dim = int(g("attention.key_length", n_embd // max(n_head, 1)))
        sections = g("rope.dimension_sections")  # qwen2vl M-RoPE
        rope = RopeConfig(
            dim=int(g("rope.dimension_count", head_dim)),
            freq_base=float(g("rope.freq_base", 10000.0)),
            scaling_type=str(g("rope.scaling.type", "none") or "none"),
            scaling_factor=float(g("rope.scaling.factor", 1.0)),
            orig_ctx_len=int(g("rope.scaling.original_context_length", 0)),
            attn_factor=float(g("rope.scaling.attn_factor", 1.0)),
            yarn_log_mul=float(g("rope.scaling.yarn_log_multiplier", 0.0)),
            sections=tuple(int(s) for s in sections) if sections is not None else (),
        )
        # feed_forward_length may be a per-layer array (deci/nemotron);
        # per-layer FFN widths aren't materialized (tensors carry their own
        # shapes) — keep the max for metadata/estimates
        nf = g("feed_forward_length", 4 * n_embd)
        try:
            n_ff = int(nf)
        except TypeError:
            n_ff = max(int(x) for x in nf)
        n_vocab = g("vocab_size")
        if n_vocab is None:
            toks = md.get("tokenizer.ggml.tokens")
            n_vocab = len(toks) if toks is not None else 0
        cfg = cls(
            arch=arch,
            n_vocab=int(n_vocab),
            n_ctx_train=int(g("context_length", 2048)),
            n_embd=n_embd,
            n_layer=int(g("block_count")),
            n_head=n_head,
            n_head_kv=n_head_kv,
            n_ff=n_ff,
            head_dim_k=head_dim,
            head_dim_v=int(g("attention.value_length", head_dim)),
            rope=rope,
            rms_norm_eps=float(g("attention.layer_norm_rms_epsilon", 1e-5)),
            n_expert=int(g("expert_count", 0) or 0),
            n_expert_used=int(g("expert_used_count", 0) or 0),
            expert_gating_func=(
                "sigmoid" if int(g("expert_gating_func", 1) or 1) == 2 else "softmax"
            ),
            expert_weights_norm=bool(g("expert_weights_norm", False)),
            expert_weights_scale=float(g("expert_weights_scale", 1.0) or 1.0),
            n_ff_exp=int(g("expert_feed_forward_length", 0) or 0),
            n_ff_shexp=int(g("expert_shared_feed_forward_length", 0) or 0),
            n_expert_shared=int(g("expert_shared_count", 0) or 0),
            moe_every_n_layers=int(g("moe_every_n_layers", 0) or 0),
            sliding_window=int(g("attention.sliding_window", 0) or 0),
            attn_logit_softcap=float(g("attn_logit_softcapping", 0.0) or 0.0),
            final_logit_softcap=float(g("final_logit_softcapping", 0.0) or 0.0),
            norm_eps=float(g("attention.layer_norm_epsilon", 1e-5) or 1e-5),
            attn_scale=float(g("attention.scale", 0.0) or 0.0),
            logit_scale=float(g("logit_scale", 1.0) or 1.0),
            residual_scale=float(g("residual_scale", 1.0) or 1.0),
            embd_scale=float(g("embedding_scale", 1.0) or 1.0),
            n_lora_q=int(g("attention.q_lora_rank", 0) or 0),
            n_lora_kv=int(g("attention.kv_lora_rank", 0) or 0),
            n_layer_dense_lead=int(g("leading_dense_block_count", 0) or 0),
            ssm_d_conv=int(g("ssm.conv_kernel", 0) or 0),
            ssm_d_inner=int(g("ssm.inner_size", 0) or 0),
            ssm_d_state=int(g("ssm.state_size", 0) or 0),
            ssm_dt_rank=int(g("ssm.time_step_rank", 0) or 0),
            ssm_dt_b_c_rms=bool(g("ssm.dt_b_c_rms", False)),
            wkv_head_size=int(g("wkv.head_size", 0) or 0),
            rescale_every_n=int(g("rescale_every_n_layers", 0) or 0),
            max_alibi_bias=float(g("attention.max_alibi_bias", 8.0) or 8.0),
            attn_clamp=float(g("attention.clamp_kqv", 0.0) or 0.0),
            n_head_arr=n_head_arr,
            n_head_kv_arr=n_head_kv_arr,
            metadata=md,
        )
        _apply_arch_defaults(cfg)
        return cfg


# arches whose GGUF contract is ggml "NORM" rope — interleaved pairs on the
# tensors AS STORED (llama_model_rope_type, src/llama-model.cpp:14229; the
# HF->GGUF converter permutes q/k for HF rotate-half models so interleaved
# rope reproduces them). Everything else uses NeoX half-split pairs.
_ROPE_NORM_ARCHES = {
    "llama", "llama4", "deci", "baichuan", "internlm2", "minicpm", "xverse",
    "command-r", "cohere2", "olmo", "arctic", "deepseek", "deepseek2",
    "chatglm", "glm4", "granite", "granitemoe", "chameleon", "bailingmoe",
    "arcee", "plm", "neo-bert",
}


def _apply_arch_defaults(cfg: ModelConfig) -> None:
    """Per-arch hardcoded hyperparameters, mirroring the reference's
    llama_model::load_hparams switch (src/llama-model.cpp:900-1500) and the
    per-arch llm_build_* graph shapes. Arch names are GGUF
    `general.architecture` strings (src/llama-arch.cpp LLM_ARCH_NAMES)."""
    import math

    a = cfg.arch
    if a in _ROPE_NORM_ARCHES:
        cfg.rope.interleaved = True
    if a == "falcon":
        # llm_build_falcon (:5421): LayerNorm, fused QKV, parallel residual,
        # plain-GELU FFN; 40B's per-branch norms keyed on attn_norm_2
        cfg.norm_type = "layer"
        cfg.ffn_act = "gelu"
        cfg.parallel_residual = True
    if a == "gptneox":
        cfg.norm_type = "layer"
        cfg.ffn_act = "gelu"
        cfg.parallel_residual = bool(
            cfg.metadata.get(f"{a}.use_parallel_residual", True)
        )
    if a in ("granite", "granitemoe"):
        # granite scales (llm_build_granite): logits are DIVIDED by
        # logit_scale, unlike command-r's multiply
        if cfg.logit_scale not in (0.0, 1.0):
            cfg.logit_scale = 1.0 / cfg.logit_scale
    if a in ("gemma", "gemma2", "gemma3"):
        cfg.embd_scale = math.sqrt(cfg.n_embd)
        cfg.ffn_act = "gelu"
    if a == "gemma2":
        cfg.post_norms = True
        cfg.swa_pattern = 2
        if cfg.sliding_window <= 0:
            cfg.sliding_window = 4096
        big = cfg.n_layer == 46  # 27B uses n_embd/n_head (llama-model.cpp:992)
        cfg.attn_scale = 1.0 / math.sqrt(
            cfg.n_embd // cfg.n_head if big else cfg.head_dim_k
        )
    elif a == "gemma3":
        cfg.post_norms = True
        cfg.swa_pattern = 6
        cfg.rope_freq_base_swa = 10000.0
        big = cfg.n_layer == 62
        cfg.attn_scale = 1.0 / math.sqrt(
            cfg.n_embd // cfg.n_head if big else cfg.head_dim_k
        )
    elif a in ("gpt2", "starcoder"):
        cfg.norm_type = "layer"
        cfg.learned_pos_embd = True
        cfg.ffn_act = "gelu"
        cfg.rope.enabled = False
    elif a == "starcoder2":
        cfg.norm_type = "layer"
        cfg.ffn_act = "gelu"
    elif a == "phi2":
        cfg.norm_type = "layer"
        cfg.ffn_act = "gelu"
        cfg.parallel_residual = True
    elif a == "olmo2":
        # post-norm architecture (llm_build_olmo2, llama-model.cpp:9710):
        # no pre-norms, branch outputs normalized; q/k norm over the full
        # projection before the head reshape
        cfg.post_norm_only = True
        cfg.post_norms = True
        cfg.qk_norm_full = True
    elif a in ("command-r", "cohere2"):
        # shared input norm feeding attention AND FFN in parallel
        # (llm_build_command_r, llama-model.cpp:9299); LayerNorm, no bias
        cfg.parallel_residual = True
        cfg.norm_type = "layer"
        if a == "cohere2" and cfg.sliding_window > 0:
            # cohere2 (load_hparams llama-model.cpp:1082): SWA pattern 4;
            # every 4th layer is full attention AND NoPE — rope is applied
            # only on SWA layers (llm_build_cohere2_iswa :9486)
            cfg.swa_pattern = 4
            cfg.n_no_rope_layer_step = 4
    elif a == "deepseek2":
        # decompressed-MHA path (llm_build_deepseek2 non-MLA branch,
        # src/llama-model.cpp:10700): every head gets its own decompressed
        # K/V, so the cache is full-MHA shaped
        cfg.n_head_kv = cfg.n_head
        # YaRN mscale folded into the attention scale; rope attn_factor
        # adjusted (llama-model.cpp:10560-10564)
        if cfg.rope.scaling_type == "yarn" and cfg.rope.scaling_factor not in (0.0, 1.0):
            freq_scale = 1.0 / cfg.rope.scaling_factor
            mscale = cfg.rope.attn_factor * (
                1.0 + cfg.rope.yarn_log_mul * math.log(1.0 / freq_scale)
            )
            cfg.attn_scale = mscale * mscale / math.sqrt(cfg.head_dim_k)
            cfg.rope.attn_factor = 1.0 / (1.0 + 0.1 * math.log(1.0 / freq_scale))
    elif a == "bloom":
        # llm_build_bloom: LayerNorm, ALiBi (no rope), fused QKV + biases,
        # GELU FFN, embedding LayerNorm (token_embd_norm)
        cfg.norm_type = "layer"
        cfg.ffn_act = "gelu"
        cfg.use_alibi = True
        cfg.rope.enabled = False
    elif a == "mpt":
        # llm_build_mpt: LayerNorm (usually no bias), ALiBi, fused QKV,
        # GELU FFN, optional clamp_kqv / qk norms
        cfg.norm_type = "layer"
        cfg.ffn_act = "gelu"
        cfg.use_alibi = True
        cfg.rope.enabled = False
    elif a == "stablelm":
        # llm_build_stablelm: LayerNorm + partial rotary (rope.dim set from
        # rope.dimension_count), optional per-head q/k norms and biases
        cfg.norm_type = "layer"
    elif a == "gptj":
        # llm_build_gptj: LayerNorm, parallel residual (attn+ffn share the
        # input norm), interleaved ("norm"-mode) partial rope, GELU
        cfg.norm_type = "layer"
        cfg.ffn_act = "gelu"
        cfg.parallel_residual = True
        cfg.rope.interleaved = True
    elif a == "nemotron":
        # llm_build_nemotron: LayerNorm(+1 baked at convert), squared-ReLU
        # FFN without gate, partial rope
        cfg.norm_type = "layer"
        cfg.ffn_act = "relu2"
    elif a == "olmoe":
        # llm_build_olmoe: rms, q/k norm over the full projection; router
        # weight norm follows the GGUF metadata when present
        cfg.qk_norm_full = True
        if f"{a}.expert_weights_norm" not in cfg.metadata:
            cfg.expert_weights_norm = True
    elif a == "dbrx":
        # llm_build_dbrx: LayerNorm no-bias, fused QKV with clamp_kqv, MoE
        cfg.norm_type = "layer"
    elif a == "refact":
        # llm_build_refact (llama-model.cpp:5943): llama block, no rope,
        # ALiBi with a hardcoded max bias (load_hparams :1186)
        cfg.rope.enabled = False
        cfg.use_alibi = True
        cfg.max_alibi_bias = 8.0
    elif a == "olmo":
        # llm_build_olmo (llama-model.cpp:9582): non-parametric LayerNorm
        # (build_norm with NULL weight/bias), optional clamp_kqv
        cfg.norm_type = "layer"
        cfg.nonparam_norms = True
    elif a == "chameleon":
        # llm_build_chameleon (llama-model.cpp:12821): per-head LayerNorm on
        # q/k ([head_dim, n_head] weights, optional bias) applied before
        # rope; optional swin post-norm ordering; image-token logits
        # suppressed (ids 4..8196, :12979-12990). The reference never reads
        # a LayerNorm eps for this arch, so the qk norm runs with eps 0.
        cfg.qk_norm_layer = True
        cfg.norm_eps = 0.0
        if bool(cfg.metadata.get(f"{a}.swin_norm", False)):
            cfg.post_norm_only = True
            cfg.post_norms = True
    elif a == "llama4":
        # llm_build_llama_iswa (llama-model.cpp:4847) + load_hparams (:574):
        # chunked attention (8k chunks, pattern 3 chunked + 1 full), NoPE
        # every 4th layer with attn-temperature tuning, L2 q/k norm (off for
        # the 128E Maverick), sigmoid router with weights applied to the
        # expert INPUT, interleaved MoE layers
        cfg.swa_type = "chunked"
        cfg.sliding_window = 8192
        cfg.swa_pattern = 4
        cfg.n_no_rope_layer_step = 4
        cfg.use_attn_temp = True
        cfg.use_kq_norm = cfg.n_expert != 128
        cfg.expert_gating_func = "sigmoid"
        cfg.moe_weight_before = True
    elif a == "arctic":
        # llm_build_arctic (:10349): MoE branch renormalizes top-k weights
        if f"{a}.expert_weights_norm" not in cfg.metadata:
            cfg.expert_weights_norm = True
    elif a == "plm":
        # llm_build_plm (llama-model.cpp:13150): MLA with direct wq +
        # compressed kv, gateless relu^2 FFN
        cfg.ffn_act = "relu2"
    elif a == "arcee":
        # llm_build_arcee (llama-model.cpp:13616): llama graph but the FFN is
        # gateless relu^2 (LLM_FFN_RELU_SQR, :13719)
        cfg.ffn_act = "relu2"
    elif a == "plamo":
        # llm_build_plamo (llama-model.cpp:7792): shared attn_norm feeds both
        # branches, out = attn + ffn + input (no ffn_norm tensor)
        cfg.parallel_residual = True
    elif a == "codeshell":
        # llm_build_codeshell (llama-model.cpp:8017): gpt2 block (LayerNorm,
        # fused qkv+bias, gelu FFN with biases) plus NEOX rope
        cfg.norm_type = "layer"
        cfg.ffn_act = "gelu"
    elif a == "jais":
        # llm_build_jais (llama-model.cpp:11238): gpt2-style LayerNorm +
        # fused qkv, ALiBi (no rope), swiglu FFN with biases, and a
        # 1/n_embd_head attention scale — NOT 1/sqrt (:11283)
        cfg.norm_type = "layer"
        cfg.use_alibi = True
        cfg.rope.enabled = False
        cfg.attn_scale = 1.0 / cfg.head_dim_k
    elif a == "grok":
        # llm_build_grok (llama-model.cpp:5545): embeddings x78.3837, unit
        # attention scale, per-branch post-norms before the residual adds,
        # gelu MoE with renormalized top-k, logits x0.57735
        cfg.embd_scale = 78.38367176906169
        # build_attn_mha grok branch (llama-graph.cpp:1080-1087):
        # kq = 30*tanh(kq * 0.08838834764831845/30), hardcoded constant
        # (1/sqrt(128)) regardless of head dim; soft_max kq_scale is 1.0
        cfg.attn_scale = 0.08838834764831845
        cfg.attn_logit_softcap = 30.0
        cfg.ffn_act = "gelu"
        cfg.post_norms = True
        cfg.logit_scale = 0.5773502691896257
        if f"{a}.expert_weights_norm" not in cfg.metadata:
            cfg.expert_weights_norm = True
    elif a == "phimoe":
        # shares llm_build_phi3 (llama-model.cpp:13933): RMS norms carry
        # biases (tensor-driven), softmax router with top-k weight renorm
        # (build_moe_ffn norm_w=true, :7746-7757); longrope factors as phi3
        if f"{a}.expert_weights_norm" not in cfg.metadata:
            cfg.expert_weights_norm = True
    elif a == "glm4":
        # llm_build_glm4: post+pre norms, partial interleaved rope, fused
        # gate_up handled by row-count detection
        cfg.post_norms = True
        cfg.rope.interleaved = True
    elif a in ("baichuan", "internlm2", "orion", "exaone", "minicpm",
               "minicpm3"):
        # minicpm3 = minicpm scalings + deepseek2-style MLA (hardcoded
        # scale_embd/scale_depth, llm_build_minicpm3 :8389-8392)
        # llama-graph clones: baichuan(7B rope) / internlm2 / exaone are
        # flag-identical to llama; orion uses LayerNorm; minicpm adds the
        # embedding/residual/logit scalings (read from metadata like granite)
        if a == "orion":
            cfg.norm_type = "layer"
        if a in ("minicpm", "minicpm3"):
            # defaults per llama-model.cpp minicpm: scale_embd 12,
            # scale_depth 1.4/sqrt(L), logits scaled by 256/n_embd
            if cfg.embd_scale == 1.0:
                cfg.embd_scale = 12.0
            if cfg.residual_scale == 1.0:
                cfg.residual_scale = 1.4 / math.sqrt(cfg.n_layer)
            if cfg.logit_scale == 1.0:
                cfg.logit_scale = 256.0 / cfg.n_embd
    elif a in ("bert", "nomic-bert", "nomic-bert-moe", "jina-bert-v2"):
        # llm_build_bert (llama-model.cpp:6042) covers all four: post-LN
        # encoder; bert = learned positions, nomic = NEOX rope (+ gated-silu
        # FFN), nomic-moe = rope + gateless-GELU MoE every 2nd layer
        # (moe_every_n_layers), jina = ALiBi (f_max_alibi_bias hardcoded 8.0,
        # load_hparams :733) + gelu-gated / GEGLU FFN
        cfg.norm_type = "layer"
        cfg.causal = False
        cfg.learned_pos_embd = a == "bert"
        cfg.ffn_act = "gelu"
        if a == "bert":
            cfg.rope.enabled = False
        elif a == "jina-bert-v2":
            cfg.rope.enabled = False
            cfg.use_alibi = True
            cfg.max_alibi_bias = 8.0
    elif a == "neo-bert":
        # llm_build_neo_bert (llama-model.cpp:6228): pre-norm RMS encoder,
        # fused bias-free qkv, NORM rope, packed-swiglu FFN (single ffn_up of
        # width 2*n_ff split in half), final enc.output_norm
        cfg.causal = False
