"""The port's copies of the JAX package's JAX-free runtime modules (chat,
grammar, json_schema, partial) give the originals' results: the JAX
package's own tests of those modules, run against the copies.

Each test file (tests/test_chat.py, test_grammar.py, test_json_schema.py,
test_partial.py) is read and executed as a new module with its imports of
`llamacog_tpu.runtime.*` pointed at `llamacog_tpu_torch.runtime.*`; every
test function of it (each parametrize case its own) becomes one case here.
The few that take a fixture (a reference GGUF file) are left to the
original file.
"""

import inspect
import types
from pathlib import Path

import pytest

TESTS = Path(__file__).resolve().parent
FILES = ("test_chat", "test_grammar", "test_json_schema", "test_partial")
_MODULES: dict = {}


def _port_module(name: str) -> types.ModuleType:
    """tests/<name>.py with its runtime imports pointed at the port."""
    if name not in _MODULES:
        src = (TESTS / f"{name}.py").read_text()
        src = src.replace("llamacog_tpu.runtime.", "llamacog_tpu_torch.runtime.")
        mod = types.ModuleType(f"port_{name}")
        mod.__file__ = str(TESTS / f"{name}.py")
        exec(compile(src, mod.__file__, "exec"), mod.__dict__)
        _MODULES[name] = mod
    return _MODULES[name]


def _cases():
    for name in FILES:
        mod = _port_module(name)
        for attr, fn in vars(mod).items():
            if not attr.startswith("test_") or not inspect.isfunction(fn):
                continue
            wanted = set(inspect.signature(fn).parameters)
            marks = [m for m in getattr(fn, "pytestmark", []) if m.name == "parametrize"]
            if not marks:
                if not wanted:
                    yield pytest.param(name, attr, {}, id=f"{name}::{attr}")
                continue
            argnames = [a.strip() for a in marks[0].args[0].split(",")] \
                if isinstance(marks[0].args[0], str) else list(marks[0].args[0])
            for i, values in enumerate(marks[0].args[1]):
                values = getattr(values, "values", values)  # pytest.param(...)
                values = values if len(argnames) > 1 else (values,)
                kwargs = dict(zip(argnames, values))
                if wanted == set(kwargs):
                    yield pytest.param(name, attr, kwargs, id=f"{name}::{attr}[{i}]")


CASES = list(_cases())


def test_copies_are_the_ports_own():
    """The executed test modules reach the port's copies, never the JAX
    package's modules."""
    used = {getattr(mod, attr).__module__ for mod in (_port_module(n) for n in FILES)
            for attr in vars(mod)
            if callable(getattr(mod, attr)) and
            getattr(getattr(mod, attr), "__module__", "").startswith("llamacog_tpu")}
    assert used and all(m.startswith("llamacog_tpu_torch.runtime.") for m in used), used
    assert len(CASES) >= 50


@pytest.mark.parametrize("name,attr,kwargs", CASES)
def test_jax_tests_pass_on_the_copies(name, attr, kwargs):
    getattr(_port_module(name), attr)(**kwargs)
