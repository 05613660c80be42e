"""chip_smoke.py's contract where there is no GPU."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_chip_smoke_fails_without_gpu():
    """On a CPU backend the script exits non-zero and prints no result."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "no GPU" in r.stdout + r.stderr
    assert '"ok"' not in r.stdout


def test_require_gpu_refuses_cpu():
    from strling_tpu.utils.device import device_info, require_gpu

    assert device_info()["platform"] == "cpu"
    with pytest.raises(RuntimeError, match="no GPU"):
        require_gpu()


@pytest.mark.parametrize("env_dir", [None, "from-env"])
def test_compile_cache_dir(monkeypatch, tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR, when set, is left to JAX; otherwise the
    cache goes to the fixed directory inside the checkout."""
    import jax

    from strling_tpu.utils.compile_cache import CACHE_DIR, enable_compile_cache

    before = jax.config.jax_compilation_cache_dir
    sentinel = str(tmp_path / "unchanged")
    jax.config.update("jax_compilation_cache_dir", sentinel)
    try:
        if env_dir:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / env_dir))
            assert enable_compile_cache() == str(tmp_path / env_dir)
            assert jax.config.jax_compilation_cache_dir == sentinel
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            assert enable_compile_cache() == CACHE_DIR
            assert CACHE_DIR == os.path.join(REPO, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == CACHE_DIR
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
