"""The port's CLI (llamacog_tpu_torch/tools/cli.py) against the JAX CLI
(llamacog_tpu/tools/cli.py) on a tiny f32 GGUF on the CPU: with the same
arguments, the default sampling with --seed 7 and --greedy print the same
text (the prompt, then each generated token's piece)."""

import pytest

from llamacog_tpu.tools.cli import main as jax_main
from llamacog_tpu.utils.testing import make_tiny_llama_gguf
from llamacog_tpu_torch.tools.cli import build_parser
from llamacog_tpu_torch.tools.cli import main as port_main


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return make_tiny_llama_gguf(str(tmp_path_factory.mktemp("cli") / "tiny.gguf"))


def _printed(main, args, capsys) -> str:
    assert main(args) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("flags", [["--seed", "7"], ["--greedy"]])
def test_cli_prints_the_jax_clis_tokens(tiny, flags, capsys):
    args = ["-m", tiny, "-p", "hello world", "-n", "24", "--dtype", "f32", "-c", "128",
            "--device", "cpu", *flags]
    want = _printed(jax_main, args, capsys)
    got = _printed(port_main, args, capsys)
    assert got.startswith("hello world") and len(got) > len("hello world\n")
    assert got == want


def test_seeded_sampling_is_repeatable_and_not_greedy(tiny, capsys):
    base = ["-m", tiny, "-p", "hello world", "-n", "24", "--dtype", "f32", "-c", "128",
            "--device", "cpu"]
    seeded = [_printed(port_main, base + ["--seed", "7"], capsys) for _ in range(2)]
    greedy = _printed(port_main, base + ["--greedy"], capsys)
    assert seeded[0] == seeded[1]
    assert seeded[0] != greedy


def test_sampling_flags_default_to_the_jax_clis():
    from llamacog_tpu.tools.cli import build_parser as jax_parser

    keys = ("temp", "top_k", "top_p", "min_p", "seed", "greedy")
    port = vars(build_parser().parse_args(["-m", "x"]))
    ref = vars(jax_parser().parse_args(["-m", "x"]))
    assert {k: port[k] for k in keys} == {k: ref[k] for k in keys}
    assert port["temp"] == 0.8 and port["greedy"] is False


def test_cli_stops_when_the_context_is_full(tiny, capsys):
    """-c 24 and -n 64: the context fills and the CLI shifts it (drops half
    of the tokens past --keep) instead of stopping, so it generates all 64
    tokens, more than the context holds."""
    from llamacog_tpu_torch.tools import cli

    args = ["-m", tiny, "-p", "hello world", "-n", "64", "--dtype", "f32", "-c", "24",
            "--device", "cpu", "--greedy"]
    assert cli.main(args) == 0
    err = capsys.readouterr().err
    n_prompt = int(err.split("prompt: ")[1].split(" tok")[0])
    n_decode = int(err.split("decode: ")[1].split(" tok")[0])
    assert n_prompt < 24 - 1 and n_prompt + n_decode > 24


@pytest.mark.parametrize("flags", [["--greedy"], ["--seed", "7"], ["--greedy", "--keep", "4"]])
def test_generation_past_the_context_prints_the_jax_clis_text(tiny, flags, capsys):
    """Past --ctx-size both CLIs shift the context the same way (the engine's
    shift_row: a gather and a re-rope of the moved keys) and print the same
    text."""
    args = ["-m", tiny, "-p", "hello world", "-n", "60", "--dtype", "f32", "-c", "24",
            "--device", "cpu", *flags]
    want = _printed(jax_main, args, capsys)
    got = _printed(port_main, args, capsys)
    assert len(got) > len("hello world\n")
    assert got == want
