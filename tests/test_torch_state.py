"""Session state (llamacog_tpu_torch/runtime/state.py) against the JAX
package's runtime/state.py, on the CPU.

A state file written by either package restores in the other: the row's
stores equal the writer's bit for bit (the dense cache in bf16 and f32, the
quantized planes of q8_0 and of the split q5_1:q4_0, which keep the JAX
layout, and the sliding-window ring of a tiny gemma2 with a window of 8,
its ring saved whole), the token history and the length come back, and a
restored engine continues as the uninterrupted one: the port's restore of
its own file gives the same logits bit for bit, and in f32 its restore of
the JAX file gives the JAX engine's greedy tokens. The four errors are the
JAX ones, message for message.
"""

import numpy as np
import pytest
import torch

from llamacog_tpu_torch.models.loader import load_model
from llamacog_tpu_torch.runtime.engine import Engine
from llamacog_tpu_torch.runtime.state import load_row_state, save_row_state

from .test_torch_arch_qwen import write_gguf

PROMPT = [(i * 37) % 250 + 3 for i in range(20)]  # past gemma2's window of 8
N_GREEDY = 8
# case: (model, jax/port dtype name, kv type, batch size, row)
CASES = {
    "dense bf16": ("llama", "bf16", "dense", 1, 0),
    "dense f32 row 1 of 2": ("llama", "f32", "dense", 2, 1),
    "q8_0": ("llama", "f32", "q8_0", 1, 0),
    "q5_1:q4_0": ("llama", "f32", "q5_1:q4_0", 1, 0),
    "ring": ("gemma2", "f32", "dense", 1, 0),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's torch ops on one thread (its models are 64 wide)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from llamacog_tpu.utils.testing import make_tiny_llama_gguf

    root = tmp_path_factory.mktemp("state")
    return {"llama": make_tiny_llama_gguf(str(root / "llama.gguf")),
            "gemma2": write_gguf(str(root / "gemma2.gguf"), "gemma2", post_norms=True,
                                 tied=True, metadata={"gemma2.attention.sliding_window": 8})}


def _jax_engine(path, dname, kv_type, batch_size):
    import jax.numpy as jnp

    from llamacog_tpu.models.loader import load_model as jax_load_model
    from llamacog_tpu.runtime.engine import Engine as JaxEngine

    dt = jnp.bfloat16 if dname == "bf16" else jnp.float32
    m = jax_load_model(path, dtype=dt)
    return JaxEngine(m.params, m.config, batch_size=batch_size, max_seq=64, dtype=dt,
                     kv_type=kv_type)


def _port_engine(path, dname, kv_type, batch_size):
    dt = torch.bfloat16 if dname == "bf16" else torch.float32
    m = load_model(path, dtype=dt, device="cpu")
    return Engine(m.params, m.config, batch_size=batch_size, max_seq=64, dtype=dt,
                  kv_type=kv_type, device="cpu")


def _bits(a) -> np.ndarray:
    """A store as numpy, bf16 as its uint16 bits."""
    if isinstance(a, torch.Tensor):
        return (a.view(torch.int16).numpy().view(np.uint16) if a.dtype == torch.bfloat16
                else a.numpy())
    a = np.asarray(a)
    return a.view(np.uint16) if str(a.dtype) == "bfloat16" else a


def _stores(eng) -> list:
    """Every store of an engine's cache, either package, in the file's
    order: dense k, v; the planes; the ring's full k, v and k_swa, v_swa."""
    c = eng.cache
    if hasattr(c, "k_swa"):
        return [c.full.k, c.full.v, c.k_swa, c.v_swa]
    if hasattr(c, "k_planes"):
        return list(c.k_planes) + list(c.v_planes)
    return [c.k, c.v]


def _row(eng, row: int) -> list:
    """The row's saved part of each store: the valid slots, the ring whole."""
    n = int(eng.seq_len[row])
    ring = hasattr(eng.cache, "k_swa")
    return [_bits(s[:, row] if ring and i >= 2 else s[:, row, :n])
            for i, s in enumerate(_stores(eng))]


def _same_rows(a, b, row):
    for x, y in zip(_row(a, row), _row(b, row), strict=True):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("case", sorted(CASES))
def test_state_files_cross_between_the_packages(files, case, tmp_path):
    from llamacog_tpu.runtime.state import load_row_state as jax_load
    from llamacog_tpu.runtime.state import save_row_state as jax_save

    model, dname, kv_type, batch, row = CASES[case]
    path = files[model]
    ej, ep = _jax_engine(path, dname, kv_type, batch), _port_engine(path, dname, kv_type, batch)
    assert type(ep.cache).__name__ == type(ej.cache).__name__
    assert ep.ring == (model == "gemma2")
    for e in (ej, ep):
        if batch > 1:
            e.prefill(PROMPT[:5], row=0)
        e.prefill(PROMPT, row=row)
    fj, fp = str(tmp_path / "jax.state"), str(tmp_path / "port.state")
    jax_save(ej, fj, row=row, tokens=PROMPT)
    save_row_state(ep, fp, row=row, tokens=PROMPT)
    # the JAX file in the port, the port's file in JAX: the writer's stores
    rp = _port_engine(path, dname, kv_type, batch)
    assert load_row_state(rp, fj, row=row) == PROMPT
    assert int(rp.seq_len[row]) == len(PROMPT)
    _same_rows(rp, ej, row)
    rj = _jax_engine(path, dname, kv_type, batch)
    assert jax_load(rj, fp, row=row) == PROMPT
    assert int(rj.seq_len[row]) == len(PROMPT)
    _same_rows(rj, ep, row)
    # the port's restore of its own file continues as the uninterrupted engine
    rp2 = _port_engine(path, dname, kv_type, batch)
    load_row_state(rp2, fp, row=row)
    toks = np.zeros(batch, dtype=np.int32)
    toks[row] = 42
    act = np.arange(batch) == row
    np.testing.assert_array_equal(rp2.decode_one(toks, active=act)[row],
                                  ep.decode_one(toks, active=act)[row])
    if dname == "f32" and batch == 1:
        # and its restore of the JAX file gives the JAX engine's greedy tokens
        np.testing.assert_array_equal(
            rp.decode_greedy_tokens([42], N_GREEDY),
            np.asarray(ej.decode_greedy_tokens(np.array([42]), N_GREEDY)))


def test_a_restored_row_writes_in_place(files, tmp_path):
    """Restore keeps the cache tensors (a captured decode graph holds their
    addresses)."""
    ep = _port_engine(files["llama"], "f32", "q8_0", 1)
    ep.prefill(PROMPT)
    save_row_state(ep, str(tmp_path / "s"), tokens=[])
    rp = _port_engine(files["llama"], "f32", "q8_0", 1)
    before = [p.data_ptr() for p in rp.cache.planes()]
    assert load_row_state(rp, str(tmp_path / "s")) == []
    assert [p.data_ptr() for p in rp.cache.planes()] == before


def _jax_error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("what", ["magic", "version", "length", "kind", "f16 mixed"])
def test_errors_are_the_jax_ones(files, tmp_path, what):
    """Bad magic, an unknown version, a length past max_seq and a cache of
    another kind raise the JAX package's ValueError in both. A mixed
    "f16:q8_0" cache's file, whose tag starts with "f", reads as a dense one
    in both (a reference defect kept in parity): it cannot be restored."""
    from llamacog_tpu.runtime.state import load_row_state as jax_load
    from llamacog_tpu.runtime.state import save_row_state as jax_save

    path = files["llama"]
    kv = {"kind": "q8_0", "f16 mixed": "f16:q8_0"}.get(what, "dense")
    src = _port_engine(path, "f32", kv, 1)
    src.prefill(list(range(2, 40)) if what == "length" else PROMPT)
    f = str(tmp_path / "s")
    save_row_state(src, f)
    if what in ("magic", "version"):
        z = dict(np.load(f))
        if what == "magic":
            z["magic"] = np.frombuffer(b"XXXX", dtype=np.uint8)
        else:
            z["version"] = np.array([2], dtype=np.int32)
        with open(f, "wb") as h:
            np.savez_compressed(h, **z)
    into = {"kind": "dense", "f16 mixed": "f16:q8_0"}.get(what, "dense")
    port = _port_engine(path, "f32", into, 1)
    jax = _jax_engine(path, "f32", into, 1)
    if what == "length":
        port.max_seq = jax.max_seq = 32
    msg = _jax_error(lambda: jax_load(jax, f))
    with pytest.raises(ValueError) as e:
        load_row_state(port, f)
    assert str(e.value) == msg
    if what == "f16 mixed":  # the JAX package's own file fails the same way
        jsrc = _jax_engine(path, "f32", kv, 1)
        jsrc.prefill(PROMPT)
        jax_save(jsrc, f)
        assert _jax_error(lambda: load_row_state(port, f)) == msg


def test_legacy_plane_names_load_in_both(files, tmp_path):
    """A q8_0 file of the first layout (planes named k_q, k_s, v_q, v_s)
    restores in both packages to the writer's planes."""
    from llamacog_tpu.runtime.state import load_row_state as jax_load

    src = _port_engine(files["llama"], "f32", "q8_0", 1)
    src.prefill(PROMPT)
    f = str(tmp_path / "s")
    save_row_state(src, f)
    z = dict(np.load(f))
    for new, old in (("kp0", "k_q"), ("kp1", "k_s"), ("vp0", "v_q"), ("vp1", "v_s")):
        z[old] = z.pop(new)
    with open(f, "wb") as h:
        np.savez_compressed(h, **z)
    port = _port_engine(files["llama"], "f32", "q8_0", 1)
    jax = _jax_engine(files["llama"], "f32", "q8_0", 1)
    load_row_state(port, f)
    jax_load(jax, f)
    _same_rows(port, src, 0)
    _same_rows(jax, src, 0)
