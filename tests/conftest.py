"""Test configuration: force an 8-device virtual CPU mesh before JAX import.

All tests run on the CPU backend with 8 fake devices so that sharding /
collective logic can be validated without multi-device hardware (the
standard JAX testing substitute for a multi-card host).  Tests marked
`gpu` run their device work in a child process that keeps the card.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# force the CPU backend explicitly, whatever plugin is installed
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402

REFERENCE_DIR = os.environ.get("SOMVQ_REFERENCE_DIR", "/root/reference")
GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


@pytest.fixture
def ref_dir():
    if not os.path.isdir(REFERENCE_DIR):
        pytest.skip("reference data directory not available")
    return REFERENCE_DIR


@pytest.fixture
def golden_dir():
    if not os.path.isdir(GOLDEN_DIR):
        pytest.skip("golden directory not available")
    return GOLDEN_DIR


@pytest.fixture(autouse=True)
def fresh_labels():
    """Reset the process-global label intern table between tests (the
    reference has one global table per process; tests are 'processes')."""
    from som_lvq_pak_tpu.data.labels import GLOBAL_LABELS

    GLOBAL_LABELS.reset()
    yield
    GLOBAL_LABELS.reset()
