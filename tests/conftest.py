import os
import sys

# Tests run on the CPU, sharding tests on a virtual 8-device CPU mesh; the
# GPU path is exercised by chip_smoke.py (and the `gpu`-marked tests).
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_PLATFORM_NAME"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

# Some environments import jax during pytest plugin discovery (before this
# conftest), freezing config defaults from the original env — override
# explicitly so an accelerator plugin never wins in tests.
try:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_platform_name", "cpu")
except Exception:
    pass

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


import pytest  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REALTEXT_32K = os.path.join(REPO, "examples", "realtext-32000-fast.vocab")


@pytest.fixture(scope="session")
def realtext_vocab():
    """The largest vocabulary the repository ships: capcode 2, delete
    token, 40,767 entries."""
    from tokenmonster_tpu.core.vocab import Vocab
    return Vocab.load(REALTEXT_32K)


@pytest.fixture(scope="session")
def realtext_cc0_vocab(realtext_vocab):
    """Its token set regenerated at capcode 0 (no delete token)."""
    from chip_smoke import regenerate_capcode0
    return regenerate_capcode0(realtext_vocab)


@pytest.fixture(params=["realtext32k", "realtext32k_cc0"])
def realtext_any(request):
    """Each of the two in-repo production-width vocabularies."""
    return request.getfixturevalue(
        "realtext_vocab" if request.param == "realtext32k"
        else "realtext_cc0_vocab")


@pytest.fixture()
def gpu_card():
    """Skips unless an NVIDIA GPU is visible (asked of nvidia-smi, so the
    test process itself stays off the card)."""
    import shutil
    import subprocess
    smi = shutil.which("nvidia-smi")
    if smi is None:
        pytest.skip("no NVIDIA GPU here (nvidia-smi not found)")
    out = subprocess.run([smi, "-L"], capture_output=True, text=True)
    if out.returncode != 0 or "GPU" not in out.stdout:
        pytest.skip("no NVIDIA GPU here")
    return out.stdout.strip()
