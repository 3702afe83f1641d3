"""The port CLI's conversation mode, prompt cache and on-device speculation
(llamacog_tpu_torch/tools/cli.py) against the JAX CLI, on the CPU.

Both CLIs run the tiny f32 GGUF of tests/test_torch_cli.py with the same
arguments and the same stdin: two -cnv turns with a system prompt under a
builtin template (and -i without one, with a reverse prompt) print the same
text; --prompt-cache saves the session on the first run and restores the
common prefix on the second (each CLI from the other's file too); and
--spec-ondevice prints the greedy tokens of a plain --greedy run.
"""

import io

import pytest

from llamacog_tpu.tools.cli import main as jax_main
from llamacog_tpu.utils.testing import make_tiny_llama_gguf
from llamacog_tpu_torch.tools.cli import main as port_main

BASE = ["-n", "12", "--dtype", "f32", "-c", "512", "--device", "cpu"]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return make_tiny_llama_gguf(str(tmp_path_factory.mktemp("cli_chat") / "tiny.gguf"))


def _run(main, args, capsys, monkeypatch, stdin=""):
    monkeypatch.setattr("sys.stdin", io.StringIO(stdin))
    assert main(args) == 0
    return capsys.readouterr()


@pytest.mark.parametrize("flags,stdin", [
    (["-cnv", "-sys", "be brief", "--chat-template", "chatml", "--greedy"],
     "hello\nhow are you\n"),
    (["-cnv", "--chat-template", "llama3", "--seed", "7"], "hi there\n\nand then?\n"),
    (["-i", "-p", "once upon", "-r", "x", "--greedy"], " a time\n"),
])
def test_conversation_turns_print_the_jax_clis_text(tiny, capsys, monkeypatch, flags, stdin):
    args = ["-m", tiny, *BASE, *flags]
    want = _run(jax_main, args, capsys, monkeypatch, stdin).out
    got = _run(port_main, args, capsys, monkeypatch, stdin).out
    assert got.count("\n> ") >= 2 and got == want


def test_prompt_cache_restores_on_the_second_run(tiny, capsys, monkeypatch, tmp_path):
    """Run 1 saves the session; run 2, whose prompt extends run 1's, restores
    it and prefills only the new tokens. Each CLI's runs print the other's
    text, and each restores the other's file."""
    files = {"jax": str(tmp_path / "jax.session"), "port": str(tmp_path / "port.session")}
    mains = {"jax": jax_main, "port": port_main}
    out = {}
    for side in ("jax", "port"):
        for i, prompt in enumerate(("hello world", "hello world again")):
            args = ["-m", tiny, *BASE, "--greedy", "-v", "-p", prompt,
                    "--prompt-cache", files[side]]
            out[side, i] = _run(mains[side], args, capsys, monkeypatch)

    def count(err, what):
        return int(err.split(what)[1].split(" tok")[0])

    assert out["port", 0].out == out["jax", 0].out
    assert out["port", 1].out == out["jax", 1].out
    assert "[cache] restored" not in out["port", 0].err
    saved = count(out["port", 0].err, "[cache] saved ")
    assert f"[cache] restored {saved} tokens" in out["port", 1].err
    # the second run prefills the tokens past the first prompt alone
    fed = [count(out[side, i].err, "prompt: ") for side in ("jax", "port") for i in (0, 1)]
    assert fed[2:] == fed[:2] and fed[3] < fed[2]
    second = count(out["port", 1].err, "[cache] saved ")
    # each CLI restores the other's second-run file and prints what the
    # other prints from no session at all
    for side, other in (("port", "jax"), ("jax", "port")):
        args = ["-m", tiny, *BASE, "--greedy", "-v", "-p", "hello world again, and",
                "--prompt-cache", files[other]]
        crossed = _run(mains[side], args, capsys, monkeypatch)
        own = _run(mains[other], args[:-1] + [str(tmp_path / f"new.{other}")], capsys,
                   monkeypatch)
        assert f"[cache] restored {second} tokens" in crossed.err
        assert crossed.out == own.out


@pytest.mark.parametrize("flags", [["--spec-ondevice", "1", "--spec-k", "2"],
                                   ["--spec-ondevice", "2", "--spec-k", "4"]])
def test_spec_ondevice_prints_the_greedy_tokens(tiny, capsys, monkeypatch, flags):
    args = ["-m", tiny, *BASE, "-p", "hello world", "-n", "40", "--greedy"]
    want = _run(jax_main, args, capsys, monkeypatch).out
    got = _run(port_main, args + flags, capsys, monkeypatch)
    assert got.out == want
    assert "[spec] drafted" in got.err


def test_spec_ondevice_with_sampling_warns_and_samples(tiny, capsys, monkeypatch):
    args = ["-m", tiny, *BASE, "-p", "hello world", "--seed", "7"]
    want = _run(jax_main, args, capsys, monkeypatch).out
    got = _run(port_main, args + ["--spec-ondevice", "1"], capsys, monkeypatch)
    assert got.out == want
    assert "greedy-exact only" in got.err and "[spec]" not in got.err
