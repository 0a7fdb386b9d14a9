"""The JAX package's own frontend-tier test cases, run against either
package: `load(name, pkg)` executes `tests/<name>.py` as a module of its
own, for `dynamo_tpu_torch` with every `dynamo_tpu.` name rewritten to the
port's (and the port's engines put on the CPU, where the JAX tests build
theirs), and `run` calls one of its test functions with its fixtures. A
test file of the port parametrises over `cases(name)`, so each JAX case
counts once per package:

    @pytest.mark.parametrize("pkg,case", cases("test_router"))
    def test_router_cases(pkg, case, request, tier_fixtures):
        run(request, tier_fixtures, "test_router", pkg, case)

A JAX test parametrised by one `pytest.mark.parametrize` becomes one case
per parameter set, named `test_x[id]` (its ids, else the values joined by
"-"), whose values `run` passes as arguments.

The fixtures a JAX test module defines are built here, module-scoped ones
once per package and module (kept in `tier_fixtures` and finalized with
it), function-scoped ones per case; pytest's own (`monkeypatch`) come from
`request`. A module's `wait_for` poll waits up to POLL_S however short its
own bound: under the suite's parallel load a NATS replication can take
longer than the JAX file's 5 s (the condition polled is the same)."""

import contextlib
import inspect
import re
import sys
import types
from pathlib import Path

import pytest
from _pytest.fixtures import FixtureFunctionDefinition

TESTS = Path(__file__).resolve().parent
PKGS = ("dynamo_tpu", "dynamo_tpu_torch")
POLL_S = 30.0
_MODULES: dict = {}


def CpuEngine(cfg, **kw):
    """The port's Engine on the CPU (a JAX test builds its engine with no
    device: the JAX package's CPU platform)."""
    from dynamo_tpu_torch.engine.engine import Engine

    return Engine(cfg, device="cpu", **kw)


def port_source(src: str) -> str:
    """A JAX test module's source, pointed at the port."""
    src = re.sub(r"\bdynamo_tpu\.", "dynamo_tpu_torch.", src)
    return re.sub(
        r"from dynamo_tpu_torch\.engine\.engine import Engine\b",
        "from torch_tier_cases import CpuEngine as Engine", src)


def load(name: str, pkg: str) -> types.ModuleType:
    key = (name, pkg)
    if key not in _MODULES:
        path = TESTS / f"{name}.py"
        src = path.read_text()
        if pkg == "dynamo_tpu_torch":
            src = port_source(src)
        mod = types.ModuleType(f"_tier_{pkg}_{name}")
        mod.__file__ = str(path)
        sys.modules[mod.__name__] = mod
        exec(compile(src, str(path), "exec"), mod.__dict__)
        poll = getattr(mod, "wait_for", None)
        if poll is not None:
            mod.wait_for = lambda pred, timeout_s=POLL_S, what="condition": \
                poll(pred, max(timeout_s, POLL_S), what)
        _MODULES[key] = mod
    return _MODULES[key]


def _parametrized(fn) -> dict:
    """A test function's parameter sets by id: {id: {argname: value}}, or
    {} when it has no parametrize mark."""
    marks = getattr(fn, "pytestmark", [])
    marks = [m for m in (marks if isinstance(marks, list) else [marks])
             if m.name == "parametrize"]
    if not marks:
        return {}
    argnames, argvalues = marks[0].args[:2]
    names = ([a.strip() for a in argnames.split(",")]
             if isinstance(argnames, str) else list(argnames))
    ids = marks[0].kwargs.get("ids")
    out = {}
    for i, vals in enumerate(argvalues):
        vals = vals if len(names) > 1 else (vals,)
        pid = ids[i] if ids else "-".join(str(v) for v in vals)
        out[pid] = dict(zip(names, vals))
    return out


def cases(name: str, only=None) -> list:
    """pytest params (pkg, test name) for every test function of
    `tests/<name>.py` (those `only` accepts; a parametrised one once per
    parameter set, `test_x[id]`), the JAX package's run first, each
    package's in file order (module-scoped fixtures carry state from case
    to case, as in the JAX file)."""
    names = []
    for n, fn in vars(load(name, "dynamo_tpu")).items():
        if not (n.startswith("test_") and inspect.isfunction(fn)
                and (only is None or only(n))):
            continue
        sets = _parametrized(fn)
        names += [f"{n}[{pid}]" for pid in sets] if sets else [n]
    return [pytest.param(pkg, n, id=f"{pkg}-{n}") for pkg in PKGS
            for n in names]


class FixtureCache(contextlib.ExitStack):
    """Module-scoped fixture values by (package, module, fixture)."""

    def __init__(self):
        super().__init__()
        self.values = {}


def _skip_marks(*objs) -> None:
    for obj in objs:
        marks = getattr(obj, "pytestmark", [])
        for mark in marks if isinstance(marks, list) else [marks]:
            if mark.name == "skipif" and mark.args and mark.args[0]:
                pytest.skip(mark.kwargs.get("reason", "skipif"))


def _fixture(request, cache: FixtureCache, mod, pkg: str, name: str):
    fdef = getattr(mod, name)
    scope = fdef._fixture_function_marker.scope
    key = (pkg, mod.__name__, name)
    if scope != "function" and key in cache.values:
        return cache.values[key]
    fn = fdef._get_wrapped_function()
    args = {a: _value(request, cache, mod, pkg, a)
            for a in inspect.signature(fn).parameters}
    got = fn(**args)
    if inspect.isgenerator(got):
        gen, got = got, next(got)
        finish = lambda: next(gen, None)  # noqa: E731
        if scope == "function":
            request.addfinalizer(finish)
        else:
            cache.callback(finish)
    if scope != "function":
        cache.values[key] = got
    return got


def _value(request, cache, mod, pkg, name):
    if isinstance(getattr(mod, name, None), FixtureFunctionDefinition):
        return _fixture(request, cache, mod, pkg, name)
    return request.getfixturevalue(name)


def run(request, cache: FixtureCache, name: str, pkg: str,
        case: str) -> None:
    mod = load(name, pkg)
    fname, _, pid = case.partition("[")
    fn = getattr(mod, fname)
    _skip_marks(mod, fn)
    given = _parametrized(fn)[pid[:-1]] if pid else {}
    fn(**{a: given[a] if a in given else _value(request, cache, mod, pkg, a)
          for a in inspect.signature(fn).parameters})
