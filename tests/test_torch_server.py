"""The port's server (llamacog_tpu_torch/server) against the JAX package's,
on the CPU.

Both ServerContexts serve the same tiny GGUF (Q4_0, n_embd 256: the port's
wire format takes rows of whole 256-weight superblocks; 2 slots, ctx 128, f32)
and get the same requests, all queued before the inference loop starts so
that both admit them in the same order: greedy completions (text and token
ids, one sharing the other's prefix), a seeded sampled one, a streamed one
whose stop string is taken from the greedy text (the stream must hold a
partial stop string back and end before it: there the JAX server streams
the stop string itself, and the port does not), a json_schema one and a
chat one. A 1-slot server with ctx 48 runs a greedy request for 80 tokens, past
its context (tests/test_server.py:270-295). The streamed chunks, the final
content, tokens_predicted and stop_reason must be equal. The port's server
also answers over HTTP, and refuses by name what it does not port.
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

SCHEMA = {"type": "object", "properties": {"ok": {"type": "boolean"}}, "required": ["ok"]}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    from llamacog_tpu.gguf import GGMLType
    from llamacog_tpu.utils.testing import make_tiny_llama_gguf

    return make_tiny_llama_gguf(str(tmp_path_factory.mktemp("srv") / "tiny.gguf"),
                                n_embd=256, n_head=4, n_head_kv=2, n_ff=512,
                                quant_type=GGMLType.Q4_0)


def _contexts(path, **kw):
    import jax.numpy as jnp

    from llamacog_tpu.models.loader import load_model as jax_load_model
    from llamacog_tpu.server.server import ServerContext as JaxServerContext

    ref = JaxServerContext(jax_load_model(path, mode="quantized", dtype=jnp.float32),
                           dtype=jnp.float32, **kw)
    port = ServerContext(load_model(path, dtype=torch.float32, device="cpu"),
                         dtype=torch.float32, device="cpu", **kw)
    return ref, port


def _collect(task) -> dict:
    chunks = []
    while True:
        msg = task.out.get(timeout=600)
        assert "error" not in msg, msg
        if msg.get("stop"):
            return {"chunks": chunks, "content": msg["content"],
                    "tokens_predicted": msg["tokens_predicted"],
                    "stop_reason": msg["stop_reason"]}
        chunks.append(msg["content"])


def _serve(ctx, requests) -> list:
    """Queue every (body, kind) before the loop starts; the results in order."""
    tasks = [ctx.make_task(dict(body), kind) for body, kind in requests]
    for t in tasks:
        ctx.pending.put(t)
    ctx.start()
    try:
        return [_collect(t) for t in tasks]
    finally:
        ctx.stop()


def test_requests_give_the_jax_servers_text(tiny):
    ref_probe, _ = _contexts(tiny, n_slots=1, ctx_size=128)
    greedy = _serve(ref_probe, [({"prompt": "hello world", "n_predict": 24,
                                  "temperature": 0.0}, "completion")])[0]["content"]
    # the stop string: the last two printable characters of the first 16
    # tokens' text that occur there first (the random model prints mostly
    # U+FFFD for byte tokens that are not UTF-8 on their own)
    head = greedy[:16]
    stop = [head[i:i + 2] for i in range(len(head) - 1)
            if "\ufffd" not in head[i:i + 2] and greedy.find(head[i:i + 2]) == i][-1]
    requests = [
        ({"prompt": "hello world", "n_predict": 16, "temperature": 0.0}, "completion"),
        ({"prompt": [1, 104, 101, 108, 108, 111, 32, 119, 111, 114], "n_predict": 12,
          "temperature": 0.0}, "completion"),
        ({"prompt": "hello world, again", "n_predict": 12, "temperature": 0.0}, "completion"),
        ({"prompt": "sampled", "n_predict": 12, "temperature": 0.8, "seed": 5}, "completion"),
        ({"prompt": "hello world", "n_predict": 24, "temperature": 0.0, "stream": True,
          "stop": [stop]}, "completion"),
        # the grammar's fallback draws from the masked logits with the
        # request's seed even at temperature 0 (runtime/sampler.py)
        ({"prompt": "json", "n_predict": 24, "temperature": 0.0, "seed": 11,
          "json_schema": SCHEMA}, "completion"),
        ({"messages": [{"role": "system", "content": "be brief"},
                       {"role": "user", "content": "hi"}], "max_tokens": 8,
          "temperature": 0.0}, "chat"),
    ]
    ref, port = _contexts(tiny, n_slots=2, ctx_size=128)
    want, got = _serve(ref, requests), _serve(port, requests)
    # the streamed request: the JAX server streams the text through the stop
    # string on the token that completes it; the port stops before it
    joined = ["".join(r["chunks"]) + r["content"] for r in (want[4], got[4])]
    assert joined[1] == joined[0][:joined[0].index(stop)] == greedy[:greedy.index(stop)]
    assert stop not in joined[1] and got[4]["tokens_predicted"] <= 16
    for r in (want[4], got[4]):
        del r["chunks"], r["content"]
    assert got == want
    assert port.metrics["prompt_tokens_cached_total"] == ref.metrics["prompt_tokens_cached_total"]
    assert port.metrics["prompt_tokens_cached_total"] > 0


def test_context_shift_gives_the_jax_servers_text(tiny):
    ref, port = _contexts(tiny, n_slots=1, ctx_size=48)
    body = {"prompt": "hello world", "n_predict": 80, "temperature": 0.0}
    want, got = (_serve(c, [(body, "completion")])[0] for c in (ref, port))
    assert got == want and got["tokens_predicted"] > 48
    assert port.metrics["context_shifts_total"] == ref.metrics["context_shifts_total"] >= 1


def _get(url):
    with urllib.request.urlopen(url, timeout=120) as r:
        return json.loads(r.read()), r.status


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read()), r.status


def test_http_endpoints(tiny):
    model = load_model(tiny, dtype=torch.float32, device="cpu")
    ctx, httpd = serve(model, host="127.0.0.1", port=0, n_slots=2, ctx_size=128,
                       dtype=torch.float32, device="cpu")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        assert _get(url + "/health") == ({"status": "ok"}, 200)
        body, _ = _get(url + "/v1/models")
        assert body["object"] == "list" and body["data"][0]["id"] == "tiny-test"
        ids, _ = _post(url + "/tokenize", {"content": "hello"})
        assert ids["tokens"] == model.tokenizer.tokenize("hello", add_special=False)
        text, _ = _post(url + "/detokenize", {"tokens": ids["tokens"]})
        assert text["content"] == model.vocab.detokenize(ids["tokens"])
        assert text["content"].endswith("hello")
        out, status = _post(url + "/v1/completions", {"prompt": "ab", "max_tokens": 4,
                                                      "temperature": 0.0})
        assert status == 200 and out["usage"]["completion_tokens"] == 4
        slots, _ = _get(url + "/slots")
        assert len(slots) == 2
        for path in ("/v1/embeddings", "/rerank"):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(url + path, {"input": "x", "query": "q", "documents": ["d"]})
            assert e.value.code == 501 and "is not ported yet" in e.value.read().decode()
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url + "/v1/chat/completions", {"messages": [
                {"role": "user", "content": [{"type": "text", "text": "hi"}]}]})
        assert e.value.code == 501
    finally:
        httpd.shutdown()
        httpd.server_close()
        ctx.stop()
        thread.join(timeout=60)
    assert not thread.is_alive() and not ctx.thread.is_alive()


@pytest.mark.parametrize("kw,what", [
    ({"loras": [object()]}, "LoRA adapters"), ({"mesh": object()}, "multi-host mirror"),
    ({"vision": object()}, "multimodal input")])
def test_refused_options_raise_by_name(tiny, kw, what):
    model = load_model(tiny, dtype=torch.float32, device="cpu")
    with pytest.raises(NotImplementedError, match=f"{what}.* is not ported yet"):
        ServerContext(model, n_slots=1, ctx_size=64, device="cpu", **kw)


@pytest.mark.parametrize("flag", [["--lora", "a.gguf"], ["--control-vector", "c.gguf"],
                                  ["--mmproj", "m"], ["-tp", "2"], ["--override-kv", "a=int:1"],
                                  ["--num-hosts", "2"], ["--coordinator", "h:1"]])
def test_main_refuses_unported_flags(flag, capsys):
    with pytest.raises(SystemExit):
        server_main.main(["-m", "x.gguf", *flag])
    assert "is not ported yet" in capsys.readouterr().err
