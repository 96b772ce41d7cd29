"""The port's runtime setup (`repro_torch.launch.env`): the reference's
four `env_overrides` contracts (tests/test_chaos.py::TestLaunchEnv) in
torch terms, `setup_runtime`'s late-call warning, and the two launchers'
shared runtime flags.  No environment variable of the process changes
for good: every test that applies a config restores `os.environ` and the
anomaly-detection switch."""
from __future__ import annotations

import argparse
import os
import warnings
from unittest import mock

import pytest
import torch

from repro_torch.launch import env as E


@pytest.fixture
def clean_runtime():
    """`os.environ` and anomaly mode as they were, after the test."""
    anomaly = torch.is_anomaly_enabled()
    with mock.patch.dict(os.environ):
        yield
    torch.autograd.set_detect_anomaly(anomaly)


def test_env_overrides_is_pure_and_merges():
    base = {E.ALLOC_CONF: "max_split_size_mb:128,expandable_segments:False",
            "TORCH_NCCL_BLOCKING_WAIT": "1"}
    keep = dict(base)
    ov = E.env_overrides(E.RuntimeConfig(nan_debug=True, preallocate=False),
                         base_env=base)
    opts = ov[E.ALLOC_CONF].split(",")
    # the unmanaged option survives; the managed one is replaced, not duped
    assert "max_split_size_mb:128" in opts
    assert opts.count("expandable_segments:True") == 1
    assert "expandable_segments:False" not in opts
    assert ov[E.NAN_CHECK] == "1"
    assert ov[E.BLOCKING_WAIT] is None       # async: the blocking wait off
    assert base == keep                      # untouched
    # a key set twice is kept once, with its last value
    ov = E.env_overrides(E.RuntimeConfig(), base_env={
        E.ALLOC_CONF: "max_split_size_mb:128,max_split_size_mb:512"})
    assert ov[E.ALLOC_CONF] == "max_split_size_mb:512"


def test_stale_nccl_names_scrubbed_never_emitted():
    """torch renamed its NCCL variables to TORCH_NCCL_*; a release that
    still reads an old name would let a stale copy override the config,
    so setup removes them and never emits one."""
    base = {name: "1" for name in E.STALE_NCCL}
    for cfg in (E.RuntimeConfig(), E.RuntimeConfig(async_collectives=False,
                                                   nan_debug=True)):
        ov = E.env_overrides(cfg, base_env=base)
        assert all(ov[name] is None for name in E.STALE_NCCL)
        assert not any(k.startswith("NCCL_") and v is not None
                       for k, v in ov.items())
    ov = E.env_overrides(E.RuntimeConfig(async_collectives=False),
                         base_env=base)
    assert ov[E.BLOCKING_WAIT] == "1"


def test_no_change_yields_empty_override():
    assert E.env_overrides(E.RuntimeConfig(), base_env={}) == {}
    cfg = E.RuntimeConfig(async_collectives=False, preallocate=False)
    base = {E.ALLOC_CONF: "expandable_segments:True",
            E.BLOCKING_WAIT: "1"}
    assert E.env_overrides(cfg, base_env=base) == {}


def test_from_args_round_trip():
    ap = argparse.ArgumentParser()
    E.add_arguments(ap)
    cfg = E.from_args(ap.parse_args(
        ["--host-devices", "8", "--nan-debug", "--no-async-collectives"]))
    assert cfg == E.RuntimeConfig(host_device_count=8, nan_debug=True,
                                  async_collectives=False)
    assert E.from_args(ap.parse_args([])) == E.RuntimeConfig()


def test_fields_without_torch_meaning_raise(clean_runtime):
    with pytest.raises(ValueError, match="extra_xla_flags"):
        E.env_overrides(E.RuntimeConfig(extra_xla_flags=("--xla_dump_to=x",)),
                        base_env={})
    with pytest.raises(ValueError, match="host-devices"):
        E.setup_runtime(E.RuntimeConfig(host_device_count=8))


def test_setup_runtime_applies_and_arms_anomaly(clean_runtime):
    os.environ["NCCL_BLOCKING_WAIT"] = "1"
    cfg = E.setup_runtime(nan_debug=True, preallocate=False)
    assert cfg == E.RuntimeConfig(nan_debug=True, preallocate=False)
    assert "NCCL_BLOCKING_WAIT" not in os.environ
    assert os.environ[E.NAN_CHECK] == "1"
    assert "expandable_segments:True" in os.environ[E.ALLOC_CONF]
    assert torch.is_anomaly_enabled()
    E.setup_runtime()
    assert not torch.is_anomaly_enabled()
    assert E.NAN_CHECK not in os.environ


def test_setup_runtime_warns_when_cuda_is_initialised(clean_runtime,
                                                      monkeypatch):
    os.environ.pop(E.ALLOC_CONF, None)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with pytest.warns(RuntimeWarning, match="already initialised"):
        E.setup_runtime(preallocate=False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")       # nothing to apply: no warning
        E.setup_runtime(preallocate=False)


@pytest.mark.parametrize("launcher", ["train", "serve"])
def test_launchers_take_the_runtime_flags(monkeypatch, launcher):
    """Both launchers parse the three flags and apply them first."""
    import importlib

    mod = importlib.import_module(f"repro_torch.launch.{launcher}")
    seen = []

    class Applied(Exception):
        pass

    def setup(cfg):
        seen.append(cfg)
        raise Applied

    monkeypatch.setattr(mod.launch_env, "setup_runtime", setup)
    with pytest.raises(Applied):
        mod.main(["--arch", "qwen3-4b", "--reduced", "--device", "cpu",
                  "--host-devices", "8", "--nan-debug",
                  "--no-async-collectives"])
    assert seen == [E.RuntimeConfig(host_device_count=8, nan_debug=True,
                                    async_collectives=False)]


@pytest.mark.parametrize("launcher", ["train", "serve"])
def test_launchers_refuse_host_devices(clean_runtime, launcher):
    import importlib

    mod = importlib.import_module(f"repro_torch.launch.{launcher}")
    with pytest.raises(ValueError, match="host-devices"):
        mod.main(["--arch", "qwen3-4b", "--reduced", "--device", "cpu",
                  "--host-devices", "2"])
