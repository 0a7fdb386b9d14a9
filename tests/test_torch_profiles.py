"""The port's worker profiles against the JAX package's, and the trtllm_tpu
profile's two rules: an `--engine-config` file is required, and warmup
always runs before serving."""

import logging
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from dynamo_tpu.serving import worker as jworker
from dynamo_tpu_torch.serving import worker

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this module: the parallel test workers share
    the cores, and torch's default pool in each of them oversubscribes
    them (the suite's tiny eager ops are as fast on one thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_profiles_equal_the_jax_profiles():
    assert set(worker.BACKEND_PROFILES) == {"jetstream", "vllm_tpu",
                                            "trtllm_tpu"}
    assert worker.BACKEND_PROFILES == jworker.BACKEND_PROFILES


@pytest.mark.parametrize("backend", sorted(worker.BACKEND_PROFILES))
def test_parser_defaults_are_the_profile(backend):
    args = worker.build_parser(backend).parse_args([])
    for key, value in worker.BACKEND_PROFILES[backend].items():
        assert getattr(args, key) == value, key


def test_trtllm_tpu_refuses_to_start_without_an_engine_config():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "dynamo_tpu_torch.trtllm_tpu", "--model",
         "tiny-debug", "--device", "cpu"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2, proc.stderr
    assert ("--engine-config FILE is required for the trtllm_tpu backend"
            in proc.stderr)


class _Stop(Exception):
    pass


@pytest.mark.parametrize("flag", [[], ["--no-warmup"]],
                         ids=["file", "file-and-flag"])
def test_trtllm_tpu_always_warms_up(tmp_path, monkeypatch, caplog, flag):
    """`warmup: false` in the engine-config (and --no-warmup) is overridden
    with a warning; the engine is warmed up before the server is built.
    The Engine is a stub, so nothing builds."""
    path = tmp_path / "engine.yaml"
    path.write_text("warmup: false\nmax_num_seqs: 3\n")
    seen = {}

    class StubEngine:
        def __init__(self, cfg, device=None):
            seen["cfg"], seen["device"] = cfg, device

        def warmup(self):
            seen["warmed"] = True

    def stop(*_, **__):
        raise _Stop

    monkeypatch.setattr(worker, "Engine", StubEngine)
    monkeypatch.setattr(worker, "ServingContext", stop)
    with caplog.at_level(logging.WARNING, logger="dynamo_tpu_torch.worker"):
        with pytest.raises(_Stop):
            worker.main(["--engine-config", str(path), "--model",
                         "tiny-debug", "--device", "cpu", *flag],
                        backend_name="trtllm_tpu")
    cfg = seen["cfg"]
    assert cfg.warmup and seen["warmed"] and cfg.max_num_seqs == 3
    assert "trtllm_tpu ignores warmup=false" in caplog.text
    for key, value in worker.BACKEND_PROFILES["trtllm_tpu"].items():
        assert getattr(cfg, key) == value, key


def test_other_profiles_keep_warmup_off_when_asked(tmp_path, monkeypatch):
    seen = {}

    class StubEngine:
        def __init__(self, cfg, device=None):
            seen["cfg"] = cfg

        def warmup(self):
            seen["warmed"] = True

    def stop(*_, **__):
        raise _Stop

    monkeypatch.setattr(worker, "Engine", StubEngine)
    monkeypatch.setattr(worker, "ServingContext", stop)
    with pytest.raises(_Stop):
        worker.main(["--model", "tiny-debug", "--no-warmup"],
                    backend_name="vllm_tpu")
    assert not seen["cfg"].warmup and "warmed" not in seen
