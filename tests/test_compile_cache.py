"""The persistent compile cache: JAX_COMPILATION_CACHE_DIR wins when set;
otherwise the cache sits at the fixed, git-ignored ``<checkout>/.jax_cache``."""

import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PROBE = "import kmcex, jax; print(jax.config.jax_compilation_cache_dir)"


def _cache_dir(env_value):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    r = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120,
                       check=True)
    return r.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("env_value", [None, "set"])
def test_compile_cache_dir(tmp_path, env_value):
    if env_value is None:
        assert _cache_dir(None) == str(ROOT / ".jax_cache")
        ignores = (ROOT / ".gitignore").read_text().split()
        assert ".jax_cache/" in ignores
    else:
        assert _cache_dir(str(tmp_path)) == str(tmp_path)
