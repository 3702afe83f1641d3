"""Static-shape KV caches: the dense store, the quantized plane store and
the sliding-window ring.

Counterpart of llamacog_tpu/runtime/kv_cache.py (KVCache, the per-kind
plane codecs, QuantKVCache, Q4KVCache, SwaKVCache, parse_kv_kinds,
make_cache). The
JAX version returns a new cache from every write; these are updated in
place (the deferred bulk write of a step lands with one index_copy_ per
plane), which saves the cache-sized copies a functional update
would cost.

The quantized planes keep the JAX package's layout exactly, so the codecs
can be checked plane against plane and a JAX cache carries across as it is
(convert.kv_cache_from_reference):

- planes are stored flat, ``[L, B, S, Hkv*W]``, in group-strided column
  order: stored column ``c = r*G + g`` holds element ``g*gs + r`` of the
  head (group size gs = 32, G = D / gs groups);
- q — packed values: int8 ``[.., D]`` (q8_0), nibble-packed uint8
  ``[.., D/2]`` (4/5-bit kinds: strided column c < D/2 in the low nibble of
  byte c, column c >= D/2 in the high nibble of byte c - D/2), or dense
  f16/bf16 ``[.., D]``;
- s — f32 per-group scale ``[.., G]`` (f32, not ggml's f16: the reference
  keeps f32 and rounding to f16 would break bit parity with it);
- m — f32 per-group min ``[.., G]`` (q4_1 / q5_1);
- h — int32 per-group pack of the 5th bits ``[.., G]``: bit r holds in-group
  index r (q5_0 / q5_1).

On the GPU the layout costs nothing: a head's row of a plane is contiguous
and the kernels undo the permutation by index (csrc/common.cuh).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class KVCache:
    k: torch.Tensor  # [L, B, S, Hkv, Dk]
    v: torch.Tensor  # [L, B, S, Hkv, Dv]

    @property
    def max_seq(self) -> int:
        return self.k.shape[2]

    @classmethod
    def create(cls, n_layers, batch, max_seq, n_head_kv, head_dim_k, head_dim_v,
               dtype=torch.bfloat16, device=None) -> "KVCache":
        return cls(
            k=torch.zeros((n_layers, batch, max_seq, n_head_kv, head_dim_k), dtype=dtype,
                          device=device),
            v=torch.zeros((n_layers, batch, max_seq, n_head_kv, head_dim_v), dtype=dtype,
                          device=device),
        )

    def read(self, layer: int):
        """(k, v) [B, S, Hkv, D] views of one layer (old contents only)."""
        return self.k[layer], self.v[layer]

    def planes(self) -> tuple:
        """Every store of the cache, each [L, B, S, ...]."""
        return (self.k, self.v)

    def row(self, r: int) -> "KVCache":
        """A cache over the [L, 1, S, ...] views of row r: a write to it
        lands in this cache in place."""
        return KVCache(self.k[:, r:r + 1], self.v[:, r:r + 1])

    def copy_row(self, src: int, dst: int) -> None:
        """Row dst's K/V become row src's, on the device."""
        for p in self.planes():
            p[:, dst].copy_(p[:, src])

    def write_all(self, k_new: torch.Tensor, v_new: torch.Tensor,
                  write_pos: torch.Tensor, active: torch.Tensor | None = None,
                  n_new: torch.Tensor | None = None) -> "KVCache":
        """Deferred bulk write of a step, in place: [L, B, T, Hkv, D] for all
        layers at per-row offsets write_pos [B] (a device tensor, so the
        decode loop needs no host sync). `active` [B] bool (on the device)
        gates the rows: a row that is not active writes nothing. The caller
        keeps write_pos + T <= max_seq for the rows it writes. A padded
        block's pads land past the row's length, as in the JAX cache, so
        `n_new` (SwaKVCache's) changes nothing here."""
        _write_planes((self.k, self.v), (k_new, v_new), write_pos, active)
        return self


def _write_planes(stores, news, write_pos: torch.Tensor,
                  active: torch.Tensor | None = None) -> None:
    """Land each [L, B, T, ...] block in its [L, B, S, ...] store at the
    per-row offsets write_pos [B], in place: one index_copy_ a store over
    the rows' slots, with no host read (the decode graph captures it). With
    `active` [B] bool each row's write is gated: the slots, clamped into
    [0, S), are read first and a row that is not active gets its own old
    values back. The clamp keeps an idle row's index in range where
    write_pos + t >= S (an idle row may sit at seq_len == max_seq;
    index_copy_ asserts on an index out of range), and the duplicate slots
    it makes there all carry the same old value."""
    L, B, S = stores[0].shape[:3]
    T = news[0].shape[2]
    slot = write_pos.long()[:, None] + torch.arange(T, device=write_pos.device)  # [B, T]
    if active is not None:
        slot = slot.clamp_(0, S - 1)
    flat = (torch.arange(B, device=slot.device)[:, None] * S + slot).reshape(B * T)
    for store, new in zip(stores, news):
        rows = store.view(L, B * S, -1)
        val = new.reshape(L, B, T, -1).to(store.dtype)
        if active is not None:
            old = rows.index_select(1, flat).view(L, B, T, -1)
            val = torch.where(active.reshape(1, B, 1, 1), val, old)
        rows.index_copy_(1, flat, val.reshape(L, B * T, -1))


# ---------------------------------------------------------------------------
# Per-kind KV plane codecs (kv_cache.py:111-224 of the JAX package). Every
# f32 operation runs in the same order as there, so the planes and the
# dequantized values are bit-exact against it.
# ---------------------------------------------------------------------------

KV_QUANT_KINDS = ("q8_0", "q4_0", "q4_1", "q5_0", "q5_1")
KV_DENSE_KINDS = ("f16", "bf16")
_DENSE_DTYPE = {"f16": torch.float16, "bf16": torch.bfloat16}


def _group_size(d: int) -> int:
    return 32 if d % 32 == 0 else d


def kv_permute(x: torch.Tensor) -> torch.Tensor:
    """Natural head-dim order -> the cache's strided store order."""
    D = x.shape[-1]
    gs = _group_size(D)
    return x.reshape(*x.shape[:-1], D // gs, gs).transpose(-1, -2).reshape(x.shape)


def kv_unpermute(x: torch.Tensor) -> torch.Tensor:
    """Strided store order -> natural head-dim order."""
    D = x.shape[-1]
    gs = _group_size(D)
    return x.reshape(*x.shape[:-1], gs, D // gs).transpose(-1, -2).reshape(x.shape)


def _pack_nibbles(q: torch.Tensor) -> torch.Tensor:
    """Strided uint8 [.., D] (values 0..15) -> packed [.., D/2]."""
    D = q.shape[-1]
    return q[..., : D // 2] | (q[..., D // 2:] << 4)


def _pack_high_bits(hi: torch.Tensor) -> torch.Tensor:
    """[.., G, gs] 0/1 high bits -> int32 [.., G], bit r = in-group index r
    (bit 31 makes the int32 negative, as in the JAX pack)."""
    gs = hi.shape[-1]
    shifts = torch.arange(gs, dtype=torch.int64, device=hi.device)
    packed = (hi.to(torch.int64) << shifts).sum(-1)
    return torch.where(packed >= 2**31, packed - 2**32, packed).to(torch.int32)


def kv_quant_planes(kind: str, x: torch.Tensor) -> tuple:
    """[..., D] natural order -> tuple of planes in canonical order."""
    D = x.shape[-1]
    gs = _group_size(D)
    G = D // gs
    if kind in KV_DENSE_KINDS:
        return (kv_permute(x).to(_DENSE_DTYPE[kind]),)
    g = x.float().reshape(*x.shape[:-1], G, gs)
    one = torch.ones((), dtype=torch.float32, device=x.device)
    if kind == "q8_0":
        d = g.abs().amax(-1, keepdim=True) / 127.0
        q = torch.where(d > 0, torch.round(g / torch.where(d > 0, d, one)),
                        torch.zeros((), device=x.device))
        return (q.transpose(-1, -2).reshape(x.shape).to(torch.int8), d.squeeze(-1))
    if kind in ("q4_0", "q5_0"):
        # quantize_row_q4_0/q5_0: d = signed max-|.| / -(2^(b-1))
        half = 8.0 if kind == "q4_0" else 16.0
        vmax = torch.gather(g, -1, g.abs().argmax(-1, keepdim=True))
        d = vmax / -half
        q = torch.where(d != 0,
                        torch.clamp(torch.round(g / torch.where(d != 0, d, one)) + half,
                                    0.0, 2 * half - 1.0),
                        torch.full((), half, device=x.device))
        extra = ()
    elif kind in ("q4_1", "q5_1"):
        levels = 15.0 if kind == "q4_1" else 31.0
        vmin = g.amin(-1, keepdim=True)
        vmax = g.amax(-1, keepdim=True)
        d = (vmax - vmin) / levels
        q = torch.where(d != 0,
                        torch.clamp(torch.round((g - vmin) / torch.where(d != 0, d, one)),
                                    0.0, levels),
                        torch.zeros((), device=x.device))
        extra = (vmin.squeeze(-1),)
    else:
        raise ValueError(f"unknown kv cache kind {kind!r}")
    q = q.to(torch.uint8)
    planes = (_pack_nibbles((q & 0xF).transpose(-1, -2).reshape(x.shape)), d.squeeze(-1),
              *extra)
    if kind in ("q5_0", "q5_1"):
        planes += (_pack_high_bits((q >> 4) & 1),)
    return planes


def kv_dequant_planes(kind: str, planes: tuple, dtype) -> torch.Tensor:
    """Strided planes [.., W] -> [..., D] natural order in `dtype`."""
    q = planes[0]
    if kind in KV_DENSE_KINDS:
        return kv_unpermute(q).to(dtype)
    s = planes[1]
    G = s.shape[-1]
    if kind == "q8_0":
        v = q.float()
    else:
        qi = q.to(torch.int32)
        v = torch.cat([qi & 0xF, qi >> 4], dim=-1).float()
    D = v.shape[-1]
    gs = D // G
    g = v.reshape(*v.shape[:-1], gs, G)  # row r = in-group index, col = group
    if kind in ("q5_0", "q5_1"):
        r = torch.arange(gs, dtype=torch.int32, device=q.device)[:, None]
        g = g + 16.0 * ((planes[-1][..., None, :] >> r) & 1).float()
    if kind == "q4_0":
        g = g - 8.0
    elif kind == "q5_0":
        g = g - 16.0
    out = g * s[..., None, :]
    if kind in ("q4_1", "q5_1"):
        out = out + planes[2][..., None, :]
    return out.transpose(-1, -2).reshape(*v.shape[:-1], D).to(dtype)


def kv_plane_shapes(kind: str, d: int) -> tuple:
    """((trailing shape, dtype), ...) of each plane for head dim d."""
    G = d // _group_size(d)
    if kind in KV_DENSE_KINDS:
        return (((d,), _DENSE_DTYPE[kind]),)
    if kind == "q8_0":
        return (((d,), torch.int8), ((G,), torch.float32))
    base = [((d // 2,), torch.uint8), ((G,), torch.float32)]
    if kind in ("q4_1", "q5_1"):
        base.append(((G,), torch.float32))
    if kind in ("q5_0", "q5_1"):
        base.append(((G,), torch.int32))
    return tuple(base)


class QuantKVCache:
    """Quantized KV cache with independent K and V kinds: a tuple of flat
    [L, B, S, Hkv*W] planes per tensor (see the module docstring). q8_0 is
    9 bits an element (about half of bf16), q4_0 5, q4_1/q5_0 6, q5_1 7;
    the attention kernels read the packed planes in place."""

    DEFAULT_KINDS = ("q8_0", "q8_0")

    def __init__(self, k_planes, v_planes, kinds=None, hkv=None):
        self.k_planes = tuple(k_planes)
        self.v_planes = tuple(v_planes)
        self.kinds = tuple(kinds) if kinds is not None else self.DEFAULT_KINDS
        self.hkv = int(hkv) if hkv is not None else None

    @property
    def max_seq(self) -> int:
        return self.k_planes[0].shape[2]

    @classmethod
    def create(cls, n_layers, batch, max_seq, n_head_kv, head_dim_k, head_dim_v,
               kinds=None, device=None) -> "QuantKVCache":
        kinds = tuple(kinds) if kinds is not None else cls.DEFAULT_KINDS

        def zeros(kind, d):
            return tuple(torch.zeros((n_layers, batch, max_seq, n_head_kv * shp[0]),
                                     dtype=dt, device=device)
                         for shp, dt in kv_plane_shapes(kind, d))

        return cls(zeros(kinds[0], head_dim_k), zeros(kinds[1], head_dim_v), kinds,
                   hkv=n_head_kv)

    @staticmethod
    def _flat(planes: tuple) -> tuple:
        """[.., H, W] per-head planes -> stored [.., H*W] form."""
        return tuple(p.reshape(*p.shape[:-2], p.shape[-2] * p.shape[-1]) for p in planes)

    def _unflat(self, planes: tuple) -> tuple:
        """Stored [.., H*W] planes -> [.., H, W] for the codecs."""
        return tuple(p.reshape(*p.shape[:-1], self.hkv, p.shape[-1] // self.hkv)
                     for p in planes)

    def quant_k(self, x: torch.Tensor) -> tuple:
        return self._flat(kv_quant_planes(self.kinds[0], x))

    def quant_v(self, x: torch.Tensor) -> tuple:
        return self._flat(kv_quant_planes(self.kinds[1], x))

    def dequant_k(self, planes: tuple, dtype=torch.bfloat16) -> torch.Tensor:
        return kv_dequant_planes(self.kinds[0], self._unflat(planes), dtype)

    def dequant_v(self, planes: tuple, dtype=torch.bfloat16) -> torch.Tensor:
        return kv_dequant_planes(self.kinds[1], self._unflat(planes), dtype)

    def read(self, layer: int, dtype=torch.bfloat16):
        """Dequantized (k, v) [B, S, Hkv, D] of one layer (old contents)."""
        return (self.dequant_k(tuple(p[layer] for p in self.k_planes), dtype),
                self.dequant_v(tuple(p[layer] for p in self.v_planes), dtype))

    def planes(self) -> tuple:
        """Every plane of the cache, K's then V's, each [L, B, S, ...]."""
        return self.k_planes + self.v_planes

    def row(self, r: int) -> "QuantKVCache":
        """A cache over the [L, 1, S, ...] views of row r's planes: a write to
        it lands in this cache in place. One layer of the view is contiguous,
        so the attention kernels read it as they read a one-row cache."""
        return type(self)(tuple(p[:, r:r + 1] for p in self.k_planes),
                          tuple(p[:, r:r + 1] for p in self.v_planes), self.kinds, self.hkv)

    def copy_row(self, src: int, dst: int) -> None:
        """Row dst's planes become row src's, on the device."""
        for p in self.planes():
            p[:, dst].copy_(p[:, src])

    def write_all(self, k_new: torch.Tensor, v_new: torch.Tensor,
                  write_pos: torch.Tensor, active: torch.Tensor | None = None,
                  n_new: torch.Tensor | None = None) -> "QuantKVCache":
        """Deferred bulk write of a step, in place: the whole [L, B, T, Hkv, D]
        block is quantized at once (never per layer: each small torch op
        costs host time every token), then each plane lands with
        index_copy_ at write_pos [B]; `active` gates the rows and `n_new`
        is ignored, as in KVCache.write_all."""
        news = self.quant_k(k_new) + self.quant_v(v_new)
        _write_planes(self.planes(), news, write_pos, active)
        return self


class Q4KVCache(QuantKVCache):
    """The (q4_0, q4_0) cache (the JAX package's alias; see QuantKVCache)."""

    DEFAULT_KINDS = ("q4_0", "q4_0")


def quant_cache_class(kinds) -> type:
    """Q4KVCache for the (q4_0, q4_0) pair, QuantKVCache otherwise."""
    return Q4KVCache if tuple(kinds) == ("q4_0", "q4_0") else QuantKVCache


class SwaKVCache:
    """Two stores, the reference's llama_kv_cache_unified_iswa and the JAX
    package's SwaKVCache (kv_cache.py:482-575): a full KVCache for the
    global-attention layers and a ring of window + 1 slots for each
    sliding-window layer, k_swa/v_swa [Ls, B, W + 1, Hkv, D]. The deferred
    write means the ring only ever holds old tokens, the last W of them:
    slot j of a row with write offset p holds absolute position
    p-1 - ((p-1-j) mod W) (ops/attention.py::swa_ring_mask). Slot W is the
    write dump: a token that is not to land (a pad, an inactive row, or
    one of more than W new tokens) is scattered there. Written in place,
    with index tensors made at construction, so a captured decode step
    copies nothing from the host.

    A row cannot be truncated (its ring would keep positions past the new
    length) or shifted: the engine refuses both by name."""

    def __init__(self, full: KVCache, k_swa: torch.Tensor, v_swa: torch.Tensor,
                 swa_layers: tuple):
        self.full = full
        self.k_swa = k_swa
        self.v_swa = v_swa
        self.swa_layers = tuple(bool(s) for s in swa_layers)
        dev = k_swa.device
        ids = [[i for i, s in enumerate(self.swa_layers) if s == want] for want in (True, False)]
        self._swa_ids = torch.tensor(ids[0], dtype=torch.long, device=dev)
        self._full_ids = torch.tensor(ids[1], dtype=torch.long, device=dev)

    @property
    def max_seq(self) -> int:
        return self.full.max_seq

    @property
    def window(self) -> int:
        return self.k_swa.shape[2] - 1  # the last slot is the write dump

    @classmethod
    def create(cls, swa_layers, batch, max_seq, window, n_head_kv, head_dim_k, head_dim_v,
               dtype=torch.bfloat16, device=None) -> "SwaKVCache":
        n_swa = sum(bool(s) for s in swa_layers)
        w = min(window, max_seq)
        return cls(
            KVCache.create(len(swa_layers) - n_swa, batch, max_seq, n_head_kv, head_dim_k,
                           head_dim_v, dtype=dtype, device=device),
            torch.zeros((n_swa, batch, w + 1, n_head_kv, head_dim_k), dtype=dtype, device=device),
            torch.zeros((n_swa, batch, w + 1, n_head_kv, head_dim_v), dtype=dtype, device=device),
            swa_layers)

    def index(self, layer: int) -> tuple[bool, int]:
        """(whether model layer `layer` is a ring layer, its index in its
        store)."""
        is_swa = self.swa_layers[layer]
        return is_swa, sum(1 for s in self.swa_layers[:layer] if s == is_swa)

    def read_ring(self, i: int):
        """(k, v) [B, W, Hkv, D] views of ring layer i (the dump slot off);
        a global layer is read from `full`."""
        return self.k_swa[i, :, :-1], self.v_swa[i, :, :-1]

    def planes(self) -> tuple:
        """Every store of the cache, each [L, B, S, ...]."""
        return self.full.planes() + (self.k_swa, self.v_swa)

    def row(self, r: int) -> "SwaKVCache":
        """A cache over row r's views: a write to it lands here in place."""
        view = SwaKVCache.__new__(SwaKVCache)
        view.full = self.full.row(r)
        view.k_swa, view.v_swa = self.k_swa[:, r:r + 1], self.v_swa[:, r:r + 1]
        view.swa_layers, view._swa_ids, view._full_ids = (self.swa_layers, self._swa_ids,
                                                          self._full_ids)
        return view

    def copy_row(self, src: int, dst: int) -> None:
        """Row dst's stores become row src's, on the device."""
        for p in self.planes():
            p[:, dst].copy_(p[:, src])

    def write_all(self, k_new: torch.Tensor, v_new: torch.Tensor,
                  write_pos: torch.Tensor, active: torch.Tensor | None = None,
                  n_new: torch.Tensor | None = None) -> "SwaKVCache":
        """The global layers' K/V go to the full store (KVCache.write_all);
        of the ring layers' [Ls, B, T, ...] block, the last W real tokens
        of each active row land at slot (write_pos + i) mod W, the rest in
        the dump slot (the JAX write_row, kv_cache.py:539-575). n_new [B]:
        the block's real tokens (None: all T)."""
        if self._full_ids.numel():
            self.full.write_all(k_new.index_select(0, self._full_ids),
                                v_new.index_select(0, self._full_ids), write_pos, active)
        if not self._swa_ids.numel():
            return self
        B, T = k_new.shape[1], k_new.shape[2]
        W = self.window
        dev = write_pos.device
        i_tok = torch.arange(T, device=dev)[None, :]
        n = (torch.full_like(write_pos, T) if n_new is None else n_new).long()[:, None]
        valid = (i_tok < n) & (i_tok >= n - W)
        if active is not None:
            valid = valid & active[:, None]
        slot = torch.where(valid, torch.remainder(write_pos.long()[:, None] + i_tok, W), W)
        flat = (torch.arange(B, device=dev)[:, None] * (W + 1) + slot).reshape(B * T)
        for store, new in ((self.k_swa, k_new), (self.v_swa, v_new)):
            ls = store.shape[0]
            val = new.index_select(0, self._swa_ids).reshape(ls, B * T, -1).to(store.dtype)
            store.view(ls, B * (W + 1), -1).index_copy_(1, flat, val)
        return self


_KIND_ALIASES = {"q8": "q8_0", "q4": "q4_0", "f32": "dense", "dense": "dense",
                 "bf16": "bf16", "f16": "f16"}


def parse_kv_kinds(kind: str) -> tuple[str, str]:
    """'q8_0' -> (q8_0, q8_0); 'q8_0:q5_1' -> split K/V kinds (the
    reference's -ctk/-ctv flags)."""
    parts = kind.split(":") if ":" in kind else [kind, kind]
    if len(parts) != 2:
        raise ValueError(f"bad kv cache type {kind!r}")
    out = []
    for p in parts:
        p = _KIND_ALIASES.get(p, p)
        if p not in KV_QUANT_KINDS + KV_DENSE_KINDS + ("dense",):
            raise ValueError(f"unknown kv cache type {p!r}")
        out.append(p)
    return tuple(out)


def make_cache(kind: str, n_layers, batch, max_seq, n_head_kv, dk, dv,
               dtype=torch.bfloat16, device=None):
    """The cache for a -ctk/-ctv kind string. Both sides dense: the dense
    KVCache in the engine's compute dtype (also for f16, as the JAX
    package does). A dense side mixed with a quantized one becomes a bf16
    plane (f16 stays f16) of the plane cache, so the kernels see one layout."""
    kk, kv = parse_kv_kinds(kind)
    dense = KV_DENSE_KINDS + ("dense",)
    if kk in dense and kv in dense:
        return KVCache.create(n_layers, batch, max_seq, n_head_kv, dk, dv, dtype=dtype,
                              device=device)
    kk = "bf16" if kk == "dense" else kk
    kv = "bf16" if kv == "dense" else kv
    return quant_cache_class((kk, kv)).create(n_layers, batch, max_seq, n_head_kv, dk, dv,
                                              kinds=(kk, kv), device=device)
