"""Device handling without fallbacks: the compile-cache placement rules,
the GPU-only entry points refusing a CPU-only backend, and the CLI
capacity preset."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from dynfu_tpu.utils import jaxcache

REPO = Path(__file__).resolve().parent.parent


class _FakeConfig:
    def __init__(self):
        self.values = {}

    def update(self, name, value):
        self.values[name] = value


@pytest.fixture
def gpu_like(monkeypatch):
    """A jax stand-in whose default backend is a GPU, with a recording
    config, so the cache rules can be checked without a card."""
    import jax

    cfg = _FakeConfig()
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(jax, "config", cfg)
    return cfg


def test_jaxcache_env_var_sets_no_directory(gpu_like, monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it itself: the
    program returns it and configures no directory of its own."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert jaxcache.enable_compilation_cache() == str(tmp_path)
    assert "jax_compilation_cache_dir" not in gpu_like.values


def test_jaxcache_fixed_path_inside_checkout(gpu_like, monkeypatch):
    """Without the variable the cache goes to one fixed, git-ignored path
    inside the checkout."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = jaxcache.enable_compilation_cache()
    assert got == str(REPO / ".jax_cache")
    assert gpu_like.values["jax_compilation_cache_dir"] == got
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


def test_jaxcache_off_on_cpu(monkeypatch, tmp_path):
    """The CPU backend stays uncached even when the environment names a
    directory (XLA:CPU's AOT loader crashes on mismatched entries)."""
    import jax

    cfg = _FakeConfig()
    monkeypatch.setattr(jax, "config", cfg)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert jax.default_backend() == "cpu"
    assert jaxcache.enable_compilation_cache() == ""
    assert cfg.values == {"jax_enable_compilation_cache": False}


@pytest.mark.parametrize("script", ["bench.py", "chip_smoke.py"])
def test_gpu_entry_points_refuse_cpu(script):
    """With no GPU visible and CPU not forced, the benchmark and the smoke
    run exit non-zero and print no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(REPO / script)], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert '"ok"' not in r.stdout and '"metric"' not in r.stdout


@pytest.mark.parametrize("mode", ["parity", "fusion"])
def test_run_dataset_applies_capacity_preset(mode, tmp_path, monkeypatch):
    """`dynfu run --volume-dims D` sizes every buffer with
    DynFuParams.caps_for_volume(D) — the 128-cube defaults would silently
    truncate a 512-cube surface."""
    import numpy as np

    from dynfu_tpu.engine.params import DynFuParams
    from dynfu_tpu.io import app, meshio

    (tmp_path / "depth").mkdir()
    meshio.save_depth_png(str(tmp_path / "depth" / "f0.png"),
                          np.full((48, 64), 1500, np.uint16))
    seen = {}

    class Stop(Exception):
        pass

    def fake_engine(params, mode=None):
        seen["params"], seen["mode"] = params, mode
        raise Stop

    monkeypatch.setattr(app, "DynFusion", fake_engine)
    with pytest.raises(Stop):
        app.run_dataset(str(tmp_path), volume_dims=512, mode=mode)
    p = seen["params"]
    want = DynFuParams.caps_for_volume(512, fusion=(mode == "fusion"))
    assert {k: getattr(p, k) for k in want} == want
    assert p.kinfu.volume_dims == (512, 512, 512)
    assert (p.kinfu.rows, p.kinfu.cols) == (48, 64)
