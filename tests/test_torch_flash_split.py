"""The split-S decode (csrc/flash_decode_dense.cu and
csrc/flash_decode_quant.cu with csrc/flash_split.cuh) on the CPU: the
host's split chooser, and the combine kernel's plain version, over split
partials made here by plain torch, held against the JAX Pallas K4 kernel
and, over the quantized planes (dequantized as the kernel does, bit for bit
as kv_dequant_planes), the Pallas K6 kernel in interpret mode.

f32 throughout. Tolerances as tests/test_torch_attention.py's decode test
(2e-5 absolute and relative): the two sides differ in summation order and
in where the softmax is rescaled (per split, then merged), not in what they
compute.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llamacog_tpu.ops.pallas import flash_q8 as jax_flash_q8
from llamacog_tpu.runtime.kv_cache import kv_quant_planes as jax_kv_quant_planes
from llamacog_tpu_torch.ops.cuda.flash_q8 import (
    SPLIT_ALIGN, SPLIT_MIN_LEN, SPLIT_TARGET_BLOCKS, choose_splits, combine_partials_plain,
    flash_decode_stacked_dense_plain)
from llamacog_tpu_torch.runtime.kv_cache import kv_dequant_planes

ATOL = RTOL = 2e-5
STACKED_TOL = 2e-4  # the JAX package's own for its stacked quantized decode (test_flash_q8.py)


def _split_bounds(n: int, s_eff: int, window: int, sp: int, split_len: int) -> tuple[int, int]:
    """Positions [start, stop) of split sp for a row at seq_len n; empty
    (start >= stop) when the split is not live (the rule of
    csrc/flash_split.cuh)."""
    lo = max(0, n - window + 1) if window > 0 else 0
    s0 = sp * split_len
    return max(s0, lo), min(s0 + split_len, min(n, s_eff))


def decode_split_partials_plain(q, k, v, seq_len, scale, softcap=0.0, window=0, s_eff=None,
                                n_split=1, split_len=None):
    """The split kernel's work in plain torch, the partials that
    combine_partials_plain merges: q [B, H, Dk] over the old cache k/v
    [B, S, Hkv, D] -> (ws [B, Hkv, n_split, rep, Dv + 2] f32 — the
    unnormalised o[Dv], the maximum m and the sum l of each live split — and
    live [B, n_split] bool). seq_len is read on the host."""
    B, H, Dk = q.shape
    Hkv, Dv = k.shape[2], v.shape[-1]
    rep = H // Hkv
    s_eff = k.shape[1] if s_eff is None else s_eff
    split_len = -(-s_eff // n_split) if split_len is None else split_len
    qf = q.float().reshape(B, Hkv, rep, Dk)
    ws = torch.zeros((B, Hkv, n_split, rep, Dv + 2), dtype=torch.float32, device=q.device)
    live = torch.zeros((B, n_split), dtype=torch.bool, device=q.device)
    for b, n in enumerate(seq_len.tolist()):
        for sp in range(n_split):
            start, stop = _split_bounds(n, s_eff, window, sp, split_len)
            if start >= stop:
                continue
            live[b, sp] = True
            s = torch.einsum("hrd,phd->hrp", qf[b], k[b, start:stop].float()) * scale
            if softcap > 0.0:
                s = softcap * torch.tanh(s / softcap)
            m = s.amax(-1)
            p = torch.exp(s - m[..., None])
            ws[b, :, sp, :, :Dv] = torch.einsum("hrp,phd->hrd", p, v[b, start:stop].float())
            ws[b, :, sp, :, Dv] = m
            ws[b, :, sp, :, Dv + 1] = p.sum(-1)
    return ws, live


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("B,Hkv", [(1, 8), (1, 2), (2, 2), (4, 8), (32, 8)])
@pytest.mark.parametrize("s_eff", [1, 17, 63, 64, 65, 384, 1000, 1024, 2048, 6144, 32768])
def test_choose_splits_covers_s_eff(B, Hkv, s_eff):
    n_split, split_len = choose_splits(s_eff, B, Hkv)
    assert n_split >= 1 and split_len % SPLIT_ALIGN == 0
    assert n_split * split_len >= s_eff                # the splits cover s_eff
    assert (n_split - 1) * split_len < s_eff           # none lies wholly past it
    assert split_len >= min(SPLIT_MIN_LEN, s_eff)      # the minimum split length
    # no more splits than about two waves of blocks want
    assert n_split <= max(1, -(-SPLIT_TARGET_BLOCKS // (B * Hkv)))


def test_choose_splits_reads_no_seq_len():
    """The choice is a function of host ints (s_eff, B, Hkv) alone: it
    takes no seq_len, so one decode loop (one kv_cap bucket) launches the
    same grid at every depth."""
    import inspect

    assert list(inspect.signature(choose_splits).parameters) == ["s_eff", "B", "Hkv"]
    assert choose_splits(1024, 1, 8) == (16, 64)       # 8B, max_seq 1024: 128 blocks
    n, length = choose_splits(32768, 1, 8)
    assert n * 8 >= 2 * 132 - 8 and length >= SPLIT_MIN_LEN


def _pallas_ref(q, k, v, kc, vc, seq_len, il, softcap, window, kv_cap):
    D = q.shape[-1]
    return np.asarray(jax_flash_q8._flash_decode_stacked_dense(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), il, jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(seq_len), D**-0.5, softcap=softcap, window=window, interpret=True,
        kv_cap=kv_cap))


def _split_path(q, k, v, kc, vc, seq_len, il, softcap, window, kv_cap, n_split):
    t = [torch.from_numpy(a) for a in (q, k, v, kc, vc, seq_len)]
    q_t, k_t, v_t, kc_t, vc_t, n_t = t
    S = k.shape[2] if kv_cap is None else min(kv_cap, k.shape[2])
    ws, live = decode_split_partials_plain(q_t, k_t[il, :, :S], v_t[il, :, :S], n_t,
                                           q.shape[-1]**-0.5, softcap=softcap, window=window,
                                           s_eff=S, n_split=n_split)
    out = combine_partials_plain(ws, live, q_t, kc_t, vc_t, q.shape[-1]**-0.5, softcap=softcap)
    return out, live


# (seq_len per row, window): rows whose splits lie past seq_len, a window
# that masks whole splits, seq_len 0 and 1 (an empty old cache), and a row
# deeper than kv_cap (the cap cuts it)
CASES = [((300, 17), 0), ((300, 17), 64), ((0, 1), 0), ((511, 200), 100), ((450, 383), 0)]


@pytest.mark.parametrize("n_split", [1, 3, 8])
@pytest.mark.parametrize("softcap", [0.0, 25.0])
@pytest.mark.parametrize("kv_cap", [None, 384])
@pytest.mark.parametrize("lens,window", CASES, ids=lambda c: str(c))
def test_split_combine_matches_pallas(n_split, softcap, kv_cap, lens, window):
    L, B, S, H, Hkv, D = 2, 2, 512, 8, 2, 32
    rng = np.random.default_rng(n_split)
    k, v = _rand(rng, L, B, S, Hkv, D), _rand(rng, L, B, S, Hkv, D)
    q, kc, vc = _rand(rng, B, H, D), _rand(rng, B, Hkv, D), _rand(rng, B, Hkv, D)
    seq_len = np.array(lens, np.int32)
    for il in range(L):
        ref = _pallas_ref(q, k, v, kc, vc, seq_len, il, softcap, window, kv_cap)
        got, live = _split_path(q, k, v, kc, vc, seq_len, il, softcap, window, kv_cap, n_split)
        assert got.shape == (B, H, D) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)
    if n_split == 8 and lens == (300, 17):
        # row 1 (seq_len 17) lives in its first split only; with the window
        # of 64, row 0's first splits (positions < 237) are not live either
        s_eff = S if kv_cap is None else kv_cap
        length = -(-s_eff // 8)
        assert live[1].tolist() == [True] + [False] * 7
        first = (300 - window + 1) // length if window else 0
        assert live[0, :first].sum() == 0 and bool(live[0, first])


def test_split_partials_are_the_plain_decode():
    """Every split count gives the plain decode (masked_attention) on the
    same inputs, B = 2 with unequal seq_len and the 8B head shape."""
    B, S, H, Hkv, D = 2, 640, 32, 8, 128
    rng = np.random.default_rng(9)
    k, v = torch.from_numpy(_rand(rng, 1, B, S, Hkv, D)), torch.from_numpy(_rand(rng, 1, B, S,
                                                                                Hkv, D))
    q = torch.from_numpy(_rand(rng, B, H, D))
    kc, vc = torch.from_numpy(_rand(rng, B, Hkv, D)), torch.from_numpy(_rand(rng, B, Hkv, D))
    seq = torch.tensor([639, 65], dtype=torch.int32)
    ref = flash_decode_stacked_dense_plain(q, k, v, 0, kc, vc, seq, D**-0.5)
    for n_split, split_len in ((1, None), *[choose_splits(S, B, Hkv)], (40, 16)):
        ws, live = decode_split_partials_plain(q, k[0], v[0], seq, D**-0.5, s_eff=S,
                                               n_split=n_split, split_len=split_len)
        got = combine_partials_plain(ws, live, q, kc, vc, D**-0.5)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL, rtol=RTOL)


# (seq_len per row, window) of the quantized-cache cases: B = 2 with unequal
# depths, a window that leaves whole splits out, an empty old cache, and a
# row deeper than the kv_cap bucket
QUANT_CASES = [((300, 17), 0), ((300, 17), 64), ((0, 1), 0), ((450, 383), 0)]


def quant_split_path(q, k_planes, v_planes, il, kc, vc, seq_len, scale, softcap, window,
                     kv_cap, kinds, n_split, split_len=None):
    """The quantized decode kernel's split rule in plain torch: layer `il`
    of the stacked planes [L, B, S, Hkv*W] dequantized (as the kernel does,
    bit for bit as kv_dequant_planes), the splits' partials, and the
    combine -> [B, H, Dv]."""
    B, Hkv = q.shape[0], kc.shape[1]
    S = k_planes[0].shape[2] if kv_cap is None else min(kv_cap, k_planes[0].shape[2])
    k, v = (kv_dequant_planes(kind, tuple(p[il, :, :S].reshape(B, S, Hkv, -1) for p in planes),
                              torch.float32)
            for kind, planes in zip(kinds, (k_planes, v_planes)))
    ws, live = decode_split_partials_plain(q, k, v, seq_len, scale, softcap=softcap,
                                           window=window, s_eff=S, n_split=n_split,
                                           split_len=split_len)
    return combine_partials_plain(ws, live, q, kc, vc, scale, softcap=softcap)


@pytest.mark.parametrize("kv_cap", [None, 384])
@pytest.mark.parametrize("lens,window", QUANT_CASES, ids=lambda c: str(c))
@pytest.mark.parametrize("kinds", [("q8_0", "q8_0"), ("q4_0", "q4_0"), ("q5_1", "q4_1")],
                         ids=lambda k: f"{k[0]}-{k[1]}")
def test_quant_split_combine_matches_pallas(kinds, lens, window, kv_cap):
    """K6's split rule (csrc/flash_decode_quant.cu) over the quantized planes
    against the Pallas flash_decode_stacked, at 1, 3 and 8 splits and at
    choose_splits' own, each with softcap off and on."""
    L, B, S, H, Hkv, D = 2, 2, 512, 8, 2, 32
    rng = np.random.default_rng(len(kinds[0]) + window)
    planes = [[np.asarray(p).reshape(L, B, S, -1) for p in jax_kv_quant_planes(
        kind, jnp.asarray(_rand(rng, L, B, S, Hkv, D)))] for kind in kinds]
    q, kc, vc = _rand(rng, B, H, D), _rand(rng, B, Hkv, D), _rand(rng, B, Hkv, D)
    seq_len = np.array(lens, np.int32)
    t_planes = [[torch.from_numpy(np.array(p)) for p in ps] for ps in planes]
    t = [torch.from_numpy(a) for a in (q, kc, vc, seq_len)]
    s_eff = S if kv_cap is None else kv_cap
    for softcap in (0.0, 25.0):
        want = np.asarray(jax_flash_q8.flash_decode_stacked(
            jnp.asarray(q), tuple(map(jnp.asarray, planes[0])),
            tuple(map(jnp.asarray, planes[1])), 1, jnp.asarray(kc), jnp.asarray(vc),
            jnp.asarray(seq_len), D**-0.5, softcap=softcap, window=window, interpret=True,
            kv_cap=kv_cap, kinds=kinds))
        for n_split, split_len in ((1, None), (3, None), (8, None), choose_splits(s_eff, B, Hkv)):
            got = quant_split_path(t[0], *t_planes, 1, t[1], t[2], t[3], D**-0.5, softcap,
                                   window, kv_cap, kinds, n_split, split_len)
            assert got.shape == (B, H, D) and got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), want, atol=STACKED_TOL, rtol=STACKED_TOL)
