"""The MoE variants' routing styles on files whose expert stacks are
quantized, held against the JAX package: the sparse routes.

An F32 file sends the MoE FFN down the all-expert einsums
(tests/test_torch_arch_moe_variants.py); a file whose expert stacks are
quantized takes the sparse top-k path, the route of every run on the card.
Three tiny files of the JAX package's oracle specs, quantized by the JAX
package's quantizer to Q8_0 (rows of 64 and 96 weights: 32-weight blocks),
one for each routing style: bailingmoe (softmax, top-k renormalized, a
shared expert), dots1 (sigmoid scores with the selection bias, weights
renormalized and scaled by 2.5, a shared expert, the dense lead layer) and
arctic (the MoE branch on the layer input beside the dense FFN). A
20-token prompt routes 40 (token, slot) rows, past _MOE_GATHER_MAX, so the
prefill takes the grouped route (K11's plain version on the CPU) and each
decode step the gather (K10's); both are counted. The f32 prefill logits
within 1e-4 of max |logit| and 16 greedy tokens equal, with the dense
cache and, for dots1, the q8_0 cache.
"""

import pytest
import torch

from llamacog_tpu.tools.quantize import quantize_model
from llamacog_tpu.utils.testing import make_tiny_arch_gguf
from llamacog_tpu_torch.models import llama
from llamacog_tpu_torch.models.loader import load_model
from llamacog_tpu_torch.ops.cuda import qmm_id
from llamacog_tpu_torch.quant import wire
from llamacog_tpu_torch.runtime.engine import Engine
from llamacog_tpu_torch.server.server import ServerContext

from .test_torch_arch_moe_variants import SPECS
from .test_torch_arch_qwen import check_same_run
from .test_torch_arch_qwen import one_torch_thread  # noqa: F401 (an autouse fixture)

PROMPT20 = [(i * 37) % 250 + 3 for i in range(20)]
# dots1 with the published routed scale of dots.llm1 (2.5)
QUANT_SPECS = {
    "bailingmoe": SPECS["bailingmoe"],
    "dots1": dict(SPECS["dots1"], extra_metadata={**SPECS["dots1"]["extra_metadata"],
                                                  "dots1.expert_weights_scale": 2.5}),
    "arctic": SPECS["arctic"],
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("arch_moe_variants_quant")
    out = {}
    for arch, spec in QUANT_SPECS.items():
        spec = dict(spec)
        src = make_tiny_arch_gguf(str(root / f"{arch}_f32.gguf"), arch, seed=spec.pop("seed"),
                                  **spec)
        out[arch] = str(root / f"{arch}_q8_0.gguf")
        quantize_model(src, out[arch], "Q8_0")
    return out


@pytest.mark.parametrize("case,kv_type", [("bailingmoe", "dense"), ("dots1", "dense"),
                                          ("dots1", "q8_0"), ("arctic", "dense")])
def test_sparse_routes_match_jax(files, case, kv_type, monkeypatch):
    """Both sparse routes run (the grouped one in the prefill, the gather at
    each decode step), and the port's logits and greedy tokens are the JAX
    package's."""
    model = load_model(files[case], device="cpu", with_tokenizer=False)
    moe = [layer for layer in model.params["layers"] if "ffn_gate_inp" in layer]
    assert moe and all(isinstance(layer["ffn_gate_up_exps"], wire.WireTensor)
                       and isinstance(layer["ffn_down_exps"], wire.WireTensor) for layer in moe)
    calls = {"ragged": 0, "gather": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(qmm_id, "qmm_ragged", counted("ragged", qmm_id.qmm_ragged))
    monkeypatch.setattr(llama, "_matmul_id", counted("gather", llama._matmul_id))
    check_same_run(files[case], kv_type, prompt=PROMPT20)
    assert calls["ragged"] > 0 and calls["gather"] > 0, calls


def test_server_serves_arctic(files):
    """The server over the quantized Arctic file: two greedy requests on two
    slots (a 2-row decode step: 4 (token, slot) rows through the gather),
    each the single-stream engine's tokens."""
    m = load_model(files["arctic"], dtype=torch.float32, device="cpu")
    ctx = ServerContext(m, n_slots=2, ctx_size=64, dtype=torch.float32, device="cpu")
    prompts = (PROMPT20, PROMPT20[5:])
    tasks = [ctx.make_task({"prompt": p, "n_predict": 6, "temperature": 0,
                            "return_tokens": True}, "completion") for p in prompts]
    for task in tasks:
        ctx.pending.put(task)
    ctx.start()
    finals = []
    try:
        for task in tasks:
            while True:
                msg = task.out.get(timeout=600)
                assert "error" not in msg, msg
                if msg.get("stop"):
                    finals.append(msg)
                    break
    finally:
        ctx.stop()
    eng = Engine(m.params, m.config, max_seq=64, dtype=torch.float32, device="cpu")
    for p, msg in zip(prompts, finals):
        eng.reset()
        assert msg["tokens"] == eng.generate_greedy(p, 6).tokens
