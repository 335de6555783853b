"""Where the persistent compile cache lands (utils.enable_compile_cache).

With JAX_COMPILATION_CACHE_DIR set the cache goes there and nowhere else;
without it, to the fixed git-ignored directory inside the checkout.  Each
case runs a fresh interpreter, since JAX reads the variable when it is
imported and fixes the cache on its first compile.
"""

import os
import subprocess
import sys
import uuid

import pytest

from athenak_jax.utils import DEFAULT_CACHE_DIR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a jitted function with a constant of its own, so its cache entry is new
PROBE = """
import sys
from athenak_jax.utils import enable_compile_cache
enable_compile_cache()
import jax, jax.numpy as jnp
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
print(jax.config.jax_compilation_cache_dir)
jax.block_until_ready(jax.jit(lambda x: x * {c})(jnp.ones(4)))
"""


def _listing(d):
    return set(os.listdir(d)) if os.path.isdir(d) else set()


@pytest.mark.parametrize("env_set", [True, False], ids=["env", "default"])
def test_compile_cache_placement(env_set, tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_set:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path)
    want = str(tmp_path) if env_set else DEFAULT_CACHE_DIR
    before_default = _listing(DEFAULT_CACHE_DIR)
    before = _listing(want)
    code = PROBE.format(c=float(uuid.uuid4().int % 10**6) + 0.5)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == want
    assert _listing(want) - before, f"no cache entry written to {want}"
    if env_set:
        assert _listing(DEFAULT_CACHE_DIR) == before_default
    assert os.path.dirname(DEFAULT_CACHE_DIR) == REPO
