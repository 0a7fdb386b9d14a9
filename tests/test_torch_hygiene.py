"""The port stands alone: no file of dynamo_tpu_torch/ (nor chip_smoke.py,
nor decode_probe.py)
imports jax or the JAX package, and importing the worker loads no jax."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted(
    str(p.relative_to(ROOT))
    for p in (ROOT / "dynamo_tpu_torch").rglob("*.py")) + [
        "chip_smoke.py", "decode_probe.py"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this module: the parallel test workers share
    the cores, and torch's default pool in each of them oversubscribes
    them (the suite's tiny eager ops are as fast on one thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _forbidden(name: str) -> bool:
    return (name in ("jax", "dynamo_tpu") or name.startswith("jax.")
            or name.startswith("dynamo_tpu."))


@pytest.mark.parametrize("rel", PORT_FILES)
def test_imports_nothing_of_jax_or_the_jax_package(rel):
    tree = ast.parse((ROOT / rel).read_text(), filename=rel)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{rel} imports {bad}"


def test_importing_the_port_loads_no_jax():
    modules = [".".join(Path(f).with_suffix("").parts)
               for f in PORT_FILES if f.startswith("dynamo_tpu_torch")]
    code = ("import importlib, sys\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m.removesuffix('.__init__'))\n"
            "assert 'jetstream' in repr(sys.modules['dynamo_tpu_torch."
            "jetstream'])\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'dynamo_tpu.')))\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
