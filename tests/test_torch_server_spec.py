"""The port's server with speculative decoding and slot state
(llamacog_tpu_torch/server), against the JAX package's server on the CPU.

Both ServerContexts serve the tiny f32 GGUF of tests/test_torch_cli.py
(n_embd 64, 4 layers here) and get the same requests, queued before the
inference loop starts: with a draft model (-md: the same weights, every
draft accepted, or a 2-layer model of another seed) greedy, seeded and
per-request `speculative` (n_max, n_min, p_min) completions; with
--spec-ondevice (one slot, the target's first layer, k = 2) a greedy and a
sampled request (the sampled one decodes token by token, as in the JAX
server). The final content, tokens_predicted, stop_reason and the draft
counts in the timings must be equal. Slots save, restore and erase through
both servers' slot_action and over HTTP; a model whose dense engine keeps
the sliding-window ring is refused for both speculative modes by name.
"""

import json
import threading
import urllib.error
import urllib.request

import pytest
import torch

from llamacog_tpu_torch.models.loader import load_model
from llamacog_tpu_torch.server import __main__ as server_main
from llamacog_tpu_torch.server.server import ServerContext, serve


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's torch ops on one thread (its models are 64 wide)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ggufs(tmp_path_factory):
    from llamacog_tpu.utils.testing import make_tiny_llama_gguf

    d = tmp_path_factory.mktemp("srv_spec")
    return {"target": make_tiny_llama_gguf(str(d / "target.gguf"), n_layer=4),
            "draft": make_tiny_llama_gguf(str(d / "draft.gguf"), n_layer=2, seed=3)}


def _contexts(ggufs, draft=None, **kw):
    """The JAX server's context and the port's on the target, f32, with the
    GGUF `draft` (a key of ggufs) as -md where given."""
    import jax.numpy as jnp

    from llamacog_tpu.models.loader import load_model as jax_load_model
    from llamacog_tpu.server.server import ServerContext as JaxServerContext

    def jax_model(name):
        return jax_load_model(ggufs[name], dtype=jnp.float32)

    def port_model(name):
        return load_model(ggufs[name], dtype=torch.float32, device="cpu")

    ref = JaxServerContext(jax_model("target"), dtype=jnp.float32,
                           draft_model=jax_model(draft) if draft else None, **kw)
    port = ServerContext(port_model("target"), dtype=torch.float32, device="cpu",
                         draft_model=port_model(draft) if draft else None, **kw)
    return ref, port


def _collect(task) -> dict:
    while True:
        msg = task.out.get(timeout=600)
        assert "error" not in msg, msg
        if msg.get("stop"):
            return {"content": msg["content"], "tokens_predicted": msg["tokens_predicted"],
                    "stop_reason": msg["stop_reason"],
                    "draft": (msg["timings"].get("draft_n"),
                              msg["timings"].get("draft_n_accepted"))}


def _serve(ctx, requests) -> list:
    """Queue every body before the loop starts; the results in order."""
    tasks = [ctx.make_task(dict(body), "completion") for body in requests]
    for t in tasks:
        ctx.pending.put(t)
    ctx.start()
    try:
        return [_collect(t) for t in tasks]
    finally:
        ctx.stop()


@pytest.mark.parametrize("draft", ["target", "draft"])
def test_draft_model_gives_the_jax_servers_text(ggufs, draft):
    requests = [
        {"prompt": "hello world", "n_predict": 16, "temperature": 0.0},
        {"prompt": "speculate", "n_predict": 12, "temperature": 0.0,
         "speculative": {"n_max": 2, "n_min": 1, "p_min": 0.0}},
        {"prompt": "sampled", "n_predict": 10, "temperature": 0.8, "seed": 5,
         "speculative": {"p_min": 0.0}},
        {"prompt": "hello world, again", "n_predict": 8, "temperature": 0.0,
         "speculative": {"n_max": 3, "p_min": 0.02}},
    ]
    ref, port = _contexts(ggufs, draft, n_slots=2, ctx_size=128)
    want, got = _serve(ref, requests), _serve(port, requests)
    assert got == want
    assert all(r["tokens_predicted"] == b["n_predict"] for r, b in zip(got, requests))
    assert got[1]["draft"][0] > 0  # the overrides' p_min 0 drafts
    if draft == "target":  # the same weights: every greedy draft is kept but
        # those past n_predict (max_accept caps the last round)
        assert got[1]["draft"][1] >= got[1]["draft"][0] - 2


def test_spec_ondevice_gives_the_jax_servers_text(ggufs):
    requests = [{"prompt": "hello world", "n_predict": 20, "temperature": 0.0},
                {"prompt": "sampled", "n_predict": 8, "temperature": 0.8, "seed": 5}]
    ref, port = _contexts(ggufs, n_slots=1, ctx_size=96, spec_ondevice=1, spec_k=2)
    want, got = _serve(ref, requests), _serve(port, requests)
    assert got == want
    assert got[0]["draft"][0] > 0 and got[1]["draft"] == (None, None)
    assert port.draft_engine.config.n_layer == 1


def test_slot_save_restore_erase(ggufs):
    """After a request, slot 0 saves to a file, slot 1 restores it and holds
    slot 0's length; both servers answer the same counts, and a bad file
    name or action raises. Erase empties the slot."""
    ref, port = _contexts(ggufs, n_slots=2, ctx_size=128)
    body = {"prompt": "hello world", "n_predict": 6, "temperature": 0.0}
    _serve(ref, [body])
    _serve(port, [body])
    answers = []
    for ctx in (ref, port):
        saved = ctx.slot_action(0, "save", {"filename": "s0.bin"})
        restored = ctx.slot_action(1, "restore", {"filename": "s0.bin"})
        assert int(ctx.engine.seq_len[1]) == int(ctx.engine.seq_len[0]) == saved["n_saved"]
        erased = ctx.slot_action(0, "erase", {})
        assert int(ctx.engine.seq_len[0]) == 0 and ctx.slots[0].cache_tokens == []
        for bad, action in (("../x", "save"), (".hidden", "restore"), ("ok.bin", "nope")):
            with pytest.raises(ValueError):
                ctx.slot_action(1, action, {"filename": bad})
        with pytest.raises(ValueError):
            ctx.slot_action(5, "erase", {})
        answers.append(({k: v for k, v in saved.items() if k not in ("timings", "n_written")},
                        {k: v for k, v in restored.items() if k not in ("timings", "n_read")},
                        erased))
    assert answers[0] == answers[1]
    assert answers[1][0]["n_saved"] == answers[1][1]["n_restored"] > 6


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read()), r.status


def test_slot_actions_over_http(ggufs):
    model = load_model(ggufs["target"], dtype=torch.float32, device="cpu")
    ctx, httpd = serve(model, host="127.0.0.1", port=0, n_slots=2, ctx_size=128,
                       dtype=torch.float32, device="cpu")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        out, _ = _post(url + "/completion", {"prompt": "ab", "n_predict": 4,
                                             "temperature": 0.0})
        saved, status = _post(url + "/slots/0?action=save", {"filename": "a.bin"})
        assert status == 200 and saved["n_saved"] > 4 and saved["n_written"] > 0
        restored, _ = _post(url + "/slots/1?action=restore", {"filename": "a.bin"})
        assert restored["n_restored"] == saved["n_saved"]
        erased, _ = _post(url + "/slots/1?action=erase", {})
        assert erased == {"id_slot": 1, "n_erased": 1}
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url + "/slots/0?action=save", {"filename": "../a.bin"})
        assert e.value.code == 400 and "invalid filename" in e.value.read().decode()
    finally:
        httpd.shutdown()
        httpd.server_close()
        ctx.stop()
        thread.join(timeout=60)


@pytest.mark.parametrize("kw", [{"draft": True}, {"spec_ondevice": 1}])
def test_speculation_over_the_ring_is_refused_by_name(tmp_path, kw):
    """A gemma2 model whose window (8) is shorter than the context keeps the
    ring on the server's dense engine: both speculative modes refuse it."""
    from .test_torch_arch_qwen import write_gguf

    path = write_gguf(str(tmp_path / "g2.gguf"), "gemma2", post_norms=True, tied=True,
                      metadata={"gemma2.attention.sliding_window": 8})
    model = load_model(path, dtype=torch.float32, device="cpu")
    draft = load_model(path, dtype=torch.float32, device="cpu") if kw.pop("draft", 0) else None
    with pytest.raises(ValueError, match="speculative decoding over a sliding-window ring"):
        ServerContext(model, n_slots=1, ctx_size=64, dtype=torch.float32, device="cpu",
                      draft_model=draft, **kw)


def test_main_takes_the_speculative_flags():
    args = server_main.build_parser().parse_args(
        ["-m", "x.gguf", "-md", "d.gguf", "--spec-ondevice", "2", "--spec-k", "3", "-np", "1"])
    assert (args.model_draft, args.spec_ondevice, args.spec_k) == ("d.gguf", 2, 3)
    assert "--model-draft" not in server_main.NOT_PORTED
