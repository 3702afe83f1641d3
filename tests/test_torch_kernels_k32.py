"""The weight kernels on rows of 32-weight-block kinds that stop short of a
whole 256-weight run, against their plain versions, on the card.

The rows are padded with zero blocks at carry time (quant/wire.py). K1/K3
(qmv) and K10 (the expert gather) read x only below K (the K tail of
csrc/common.cuh::qmv_walk, and of K10's own walk in csrc/qmv_id.cu, which
groups the rows by expert); K2/K3 at prefill (qgemm) and K11 (the grouped
GEMM) take x padded with zero columns. Held at K = 96, 160 and 896
(Qwen2.5-0.5B's n_embd), B 1-9 and 40, mixed kinds in one launch. These
tests carry the `cuda` marker and skip where no GPU is present (the CUDA
kernels have no CPU mode); on the card: python -m pytest --noconftest
tests/test_torch_kernels_k32.py -m cuda.
"""

import pytest
import torch

from llamacog_tpu_torch.ops.cuda import qmm, qmm_id
from llamacog_tpu_torch.utils.synthetic import random_experts, random_wire

pytestmark = pytest.mark.cuda
KINDS = ["Q4_0", "Q4_1", "Q5_0", "Q5_1", "Q8_0", "IQ4_NL"]
TOL = 1e-4


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rel(got, want):
    return float((got.cpu().double() - want.double()).abs().max()) / float(
        want.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("k", [96, 160, 896])
@pytest.mark.parametrize("kind", KINDS)
def test_qmv_qgemm_on_padded_rows(dev, kind, k):
    g = torch.Generator(device=dev).manual_seed(k)
    w = random_wire(kind, 300, k, g, dev)
    for b, dt in ((1, torch.float32), (3, torch.bfloat16), (8, torch.float32),
                  (9, torch.bfloat16), (40, torch.bfloat16)):
        x = torch.randn((b, k), generator=g, device=dev).to(dt)
        got = qmm.qmm_multi_cuda(x, [w])[0]
        assert _rel(got, qmm.qmm_plain(x.cpu(), w.to("cpu"))) <= TOL, (b, dt)


@pytest.mark.parametrize("b", [1, 4, 64])
def test_mixed_kinds_one_launch_on_padded_rows(dev, b):
    """A Qwen2.5-0.5B layer's attn_qk (Q5_0) + attn_v (Q8_0) launch at K 896."""
    g = torch.Generator(device=dev).manual_seed(b)
    ws = [random_wire("Q5_0", 1024, 896, g, dev), random_wire("Q8_0", 128, 896, g, dev)]
    x = torch.randn((b, 896), generator=g, device=dev).to(torch.bfloat16)
    for got, w in zip(qmm.qmm_multi_cuda(x, ws), ws):
        assert _rel(got, qmm.qmm_plain(x.cpu(), w.to("cpu"))) <= TOL


@pytest.mark.parametrize("k", [160, 896])
@pytest.mark.parametrize("kind", ["Q5_0", "Q8_0", "IQ4_NL"])
def test_expert_kernels_on_padded_rows(dev, kind, k):
    g = torch.Generator(device=dev).manual_seed(k)
    stack = random_experts(kind, 8, 256, k, g, dev)
    x = torch.randn((32, k), generator=g, device=dev).to(torch.bfloat16)
    ids = torch.randint(0, 8, (32,), generator=g, device=dev, dtype=torch.int32)
    got = qmm_id.qmm_gather(x, ids, stack)
    assert _rel(got, qmm_id.qmm_gather_plain(x.cpu(), ids.cpu(), stack.to("cpu"))) <= TOL
    te = torch.tensor([0, 3, 3, 7, 8], dtype=torch.int32, device=dev)
    xs = torch.randn((80, k), generator=g, device=dev).to(torch.bfloat16)
    got = qmm_id.qmm_ragged(xs, te, stack, 16)
    want = qmm_id.qmm_ragged_plain(xs.cpu(), te.cpu(), stack.to("cpu"), 16)
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("S,routing", [(1, "random"), (8, "one"), (32, "two"), (32, "random"),
                                       (300, "random")])
@pytest.mark.parametrize("k", [160, 896])
@pytest.mark.parametrize("kind", KINDS)
def test_qmv_id_groups_padded_rows(dev, kind, k, S, routing, monkeypatch):
    """K10's rows grouped by expert over padded stacks: one row, 8 rows on
    one expert, 32 on two, 32 routed at random and 300 f32 rows (the f32
    ragged route's count: a block per row); 2 to 32 rows also through the
    grouping kernel where the rule would take a block per row."""
    g = torch.Generator(device=dev).manual_seed(S + k)
    stack = random_experts(kind, 8, 136, k, g, dev)
    x = torch.randn((S, k), generator=g, device=dev).to(
        torch.float32 if S > 32 else torch.bfloat16)
    if routing == "one":
        ids = torch.full((S,), 5, dtype=torch.int32, device=dev)
    elif routing == "two":
        ids = torch.arange(S, dtype=torch.int32, device=dev) % 2 * 3
    else:
        ids = torch.randint(0, 8, (S,), generator=g, device=dev, dtype=torch.int32)
    got = qmm_id.qmm_gather(x, ids, stack)
    assert _rel(got, qmm_id.qmm_gather_plain(x.cpu(), ids.cpu(), stack.to("cpu"))) <= TOL
    if 2 <= S <= qmm_id.GATHER_GROUP_MAX:  # the other kernel: the same bits
        grouped = qmm_id.gather_groups(S, 8)
        monkeypatch.setattr(qmm_id, "gather_groups", lambda S, n_exp: not grouped)
        assert torch.equal(qmm_id.qmm_gather(x, ids, stack), got)
