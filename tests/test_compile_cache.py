"""The persistent compile cache lands where JAX_COMPILATION_CACHE_DIR says,
or at the fixed git-ignored path in the checkout."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = (
    "import jax, jax.numpy as jnp;"
    "from cuda_acceleratedvectordatabaseengine.utils.compile_cache import "
    "enable_compile_cache;"
    "path = enable_compile_cache();"
    "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0);"
    "jax.config.update('jax_persistent_cache_min_entry_size_bytes', 0);"
    "jax.jit(lambda x: jnp.sin(x) * 3)(jnp.ones(7)).block_until_ready();"
    "print(path)"
)


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_location(tmp_path, env_set):
    from cuda_acceleratedvectordatabaseengine.utils.compile_cache import (
        DEFAULT_DIR,
    )

    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    want = str(tmp_path / "cc") if env_set else DEFAULT_DIR
    if env_set:
        env["JAX_COMPILATION_CACHE_DIR"] = want
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=tmp_path, env=env | {
            "PYTHONPATH": REPO}, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == want
    assert os.path.isdir(want) and os.listdir(want)
    assert os.path.dirname(DEFAULT_DIR) == REPO
    # nothing written at the other location by this run
    assert not (tmp_path / ".jax_cache").exists()
