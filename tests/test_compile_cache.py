"""The compile-cache helper: JAX_COMPILATION_CACHE_DIR wins when set (and
nothing else is changed); otherwise the cache sits at <checkout>/.tmp/jaxcache.
Each case runs in a fresh interpreter so the global JAX config of the test
process is left alone."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = (
    "import jax\n"
    "from tokenmonster_tpu.utils.compile_cache import enable_compile_cache\n"
    "print(enable_compile_cache())\n"
    "print(jax.config.jax_compilation_cache_dir)\n"
    "print(jax.config.jax_persistent_cache_min_compile_time_secs)\n")


def _probe(env_dir):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    out = subprocess.run([sys.executable, "-c", PROBE], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout.split("\n")[:3]


def test_env_var_set_is_used_as_is(tmp_path):
    d = str(tmp_path / "cc")
    used, config_dir, min_secs = _probe(d)
    assert used == d
    assert config_dir == d            # JAX read the variable itself
    assert float(min_secs) == 1.0     # nothing else was changed


def test_env_var_unset_uses_checkout_tmp():
    used, config_dir, _ = _probe(None)
    want = os.path.join(REPO, ".tmp", "jaxcache")
    assert used == want
    assert config_dir == want
