"""Sequence state snapshot/restore (reference: llama_state_seq_save_file /
llama_state_save_file, include/llama.h:806-902; powers the server's slot
save/restore and the CLI's --prompt-cache).

Counterpart of llamacog_tpu/runtime/state.py, in its file format: an npz
with the magic ``LCGS``, version 1, the row's valid length ``seq_len``, its
token history ``tokens`` (may be empty), a ``kind`` tag and the row's KV
slice. A dense cache stores ``k``/``v`` [L, n, Hkv, D] with a ``dtype``
tag (bf16 as its uint16 bit pattern: numpy has no bfloat16); a quantized
one (``kind`` "k_kind:v_kind") its planes ``kp0``.. and ``vp0``.. [L, n,
Hkv*W] in the cache's own order (the port's planes keep the JAX layout
bit for bit, runtime/kv_cache.py, so no plane is converted; a bf16 or f16
plane of a mixed cache is stored as bits or as f16); the sliding-window
ring (``kind`` "iswa") the full store's ``k``/``v`` over n slots and each
ring's ``k_swa``/``v_swa`` whole (its slots encode positions by seq_len).
A file written by either package loads in the other.

Restore writes into the engine's cache tensors in place, so the decode
graphs captured on the engine keep their addresses.
"""

from __future__ import annotations

import numpy as np
import torch

from .engine import Engine
from .kv_cache import KVCache, QuantKVCache, SwaKVCache

STATE_MAGIC = "LCGS"
STATE_VERSION = 1


def _tag(text: str) -> np.ndarray:
    return np.frombuffer(text.encode(), dtype=np.uint8)


def _to_file(t: torch.Tensor) -> np.ndarray:
    """A cache slice as the file stores it: bf16 as its uint16 bits."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _dtype_tag(t: torch.Tensor) -> np.ndarray:
    return _tag("bf16" if t.dtype == torch.bfloat16 else str(t.dtype).replace("torch.", ""))


def _from_file(a: np.ndarray, bf16: bool) -> torch.Tensor:
    """A stored array back as a tensor: uint16 bits as bf16 where tagged."""
    if bf16:
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def save_row_state(engine: Engine, path: str, row: int = 0, tokens: list[int] | None = None):
    """Write `row`'s valid KV slice and `tokens` to `path`."""
    n = int(engine.seq_len[row])
    arrays: dict[str, np.ndarray] = {
        "magic": _tag(STATE_MAGIC),
        "version": np.array([STATE_VERSION], dtype=np.int32),
        "seq_len": np.array([n], dtype=np.int32),
        "tokens": np.asarray(tokens if tokens is not None else [], dtype=np.int32),
    }
    c = engine.cache
    if isinstance(c, QuantKVCache):
        # canonical tag "kind_k:kind_v"; planes saved positionally
        arrays["kind"] = _tag(":".join(c.kinds))
        for tag, planes in (("k", c.k_planes), ("v", c.v_planes)):
            for i, p in enumerate(planes):
                arrays[f"{tag}p{i}"] = _to_file(p[:, row, :n])
    elif isinstance(c, SwaKVCache):
        arrays["kind"] = _tag("iswa")
        arrays["dtype"] = _dtype_tag(c.full.k)
        arrays["k"] = _to_file(c.full.k[:, row, :n])
        arrays["v"] = _to_file(c.full.v[:, row, :n])
        arrays["k_swa"] = _to_file(c.k_swa[:, row])
        arrays["v_swa"] = _to_file(c.v_swa[:, row])
    else:
        arrays["kind"] = _tag("dense")
        arrays["dtype"] = _dtype_tag(c.k)
        arrays["k"] = _to_file(c.k[:, row, :n])
        arrays["v"] = _to_file(c.v[:, row, :n])
    # write through a handle: np.savez would append ".npz" to bare paths
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)


def load_row_state(engine: Engine, path: str, row: int = 0) -> list[int]:
    """Restores a row in place; returns the saved token history (may be
    empty). Raises ValueError, as the JAX package does, on a bad magic or
    version, a length past the engine's max_seq, or a cache of another
    kind. As there, a kind tag that starts with "f" (a mixed "f16:q8_0"
    cache) is read as a dense cache."""
    z = np.load(path)
    if bytes(z["magic"]).decode() != STATE_MAGIC:
        raise ValueError("bad state file magic")
    if int(z["version"][0]) != STATE_VERSION:
        raise ValueError(f"unsupported state version {z['version'][0]}")
    n = int(z["seq_len"][0])
    if n > engine.max_seq:
        raise ValueError(f"state length {n} exceeds engine max_seq {engine.max_seq}")
    kind = bytes(z["kind"]).decode()
    bf16 = "dtype" in z and bytes(z["dtype"]).decode() == "bf16"
    c = engine.cache

    def put(dst: torch.Tensor, a: np.ndarray, bits: bool) -> None:
        dst.copy_(_from_file(a, bits).to(dst.dtype))

    if kind not in ("iswa", "dense") and not kind.startswith("f"):
        kinds = tuple(kind.split(":")) if ":" in kind else (kind, kind)
        if not isinstance(c, QuantKVCache) or c.kinds != kinds:
            have = c.kinds if isinstance(c, QuantKVCache) else type(c).__name__
            raise ValueError(f"state is {kinds} but engine cache is {have}")
        if "k_q" in z:  # legacy v1 layout (fixed q/s plane names)
            loaded = {"kp0": z["k_q"], "kp1": z["k_s"], "vp0": z["v_q"], "vp1": z["v_s"]}
        else:
            loaded = {key: z[key] for key in z.files if key[1:2] == "p"}
        for tag, planes in (("k", c.k_planes), ("v", c.v_planes)):
            for i, p in enumerate(planes):
                put(p[:, row, :n], loaded[f"{tag}p{i}"], p.dtype == torch.bfloat16)
    elif kind == "iswa":
        if not isinstance(c, SwaKVCache):
            raise ValueError("state is iswa but engine cache is not")
        put(c.full.k[:, row, :n], z["k"], bf16)
        put(c.full.v[:, row, :n], z["v"], bf16)
        put(c.k_swa[:, row], z["k_swa"], bf16)
        put(c.v_swa[:, row], z["v_swa"], bf16)
    else:
        if not isinstance(c, KVCache):
            raise ValueError("state is dense but engine cache is quantized")
        put(c.k[:, row, :n], z["k"], bf16)
        put(c.v[:, row, :n], z["v"], bf16)
    engine.seq_len[row] = n
    return [int(t) for t in z["tokens"]]
