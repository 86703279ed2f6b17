"""Compile-cache placement: JAX_COMPILATION_CACHE_DIR wins when set;
otherwise the cache lives in .jax_cache/ at the checkout root."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cache_dir(env_dir):
    env = {k: v for k, v in os.environ.items()
           if k not in ("CANU_TPU_NO_COMPILE_CACHE",
                        "JAX_COMPILATION_CACHE_DIR")}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    r = subprocess.run(
        [sys.executable, "-c",
         "import canu_tpu, jax; print(jax.config.jax_compilation_cache_dir)"],
        env=env, capture_output=True, text=True, timeout=120, cwd="/",
    )
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("from_env", [False, True])
def test_compile_cache_dir(tmp_path, from_env):
    want = str(tmp_path / "cc") if from_env else os.path.join(REPO, ".jax_cache")
    assert _cache_dir(want if from_env else None) == want
