"""The single platform/kernel predicate, the compile-cache directory rule,
and chip_smoke.py's refusal to run without a GPU."""
import os
import shutil
import subprocess
import sys

import jax
import pytest

from line3d_tpu import L3DConfig
from line3d_tpu.cluster import diffusion
from line3d_tpu.fit import refine
from line3d_tpu.utils import backend, xla_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def fake_platform(monkeypatch):
    def set_platform(name):
        monkeypatch.setattr(jax, "default_backend", lambda: name)
    return set_platform


def test_cpu_runs_twins_and_host_backends(fake_platform):
    fake_platform("cpu")
    assert not backend.on_gpu()
    assert not backend.use_kernels()
    cfg = L3DConfig()
    assert diffusion.resolve_backend(cfg) == "host"
    assert refine.resolve_backend(cfg) == "host"


def test_gpu_runs_kernels_and_device_backends(fake_platform):
    fake_platform("gpu")
    assert backend.on_gpu()
    assert backend.use_kernels()
    cfg = L3DConfig()            # "auto" diffusion / refine backends
    assert diffusion.resolve_backend(cfg) == "device"
    assert refine.resolve_backend(cfg) == "device"


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_explicit_backend_passes_through(fake_platform, platform):
    fake_platform(platform)
    for value in ("host", "device"):
        assert backend.resolve_auto_backend(value) == value
        assert diffusion.resolve_backend(
            L3DConfig(diffusion_backend=value)) == value


def test_twins_only_forces_twins_on_gpu(fake_platform):
    fake_platform("gpu")
    with backend.twins_only():
        assert not backend.use_kernels()
        assert backend.resolve_auto_backend("auto") == "device"
    assert backend.use_kernels()


def test_cache_dir_from_environment_is_left_alone(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert xla_cache.cache_dir() is None
    xla_cache.enable_persistent_cache()
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_dir_defaults_into_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = xla_cache.cache_dir()
    assert path == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
    xla_cache.enable_persistent_cache()
    assert jax.config.jax_compilation_cache_dir == path


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_refuses_without_gpu():
    out = _run_smoke(REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run_smoke(str(tmp_path))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
