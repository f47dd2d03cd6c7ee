"""Test config: the suite runs on XLA's CPU backend with 8 virtual devices.

Sharding paths are validated on the host platform's virtual devices.
Tests of code that runs only on the GPU carry the `gpu` marker and take
the `gpu_device` fixture, which skips them when no card is present; run
them on a machine with a card by `BODA_TEST_GPU=1 python -m pytest -m gpu
tests/`.
"""

import os

if os.environ.get("BODA_TEST_GPU") != "1":
    _flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8").strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

import pytest  # noqa: E402


@pytest.fixture()
def tmp_out(tmp_path):
    return tmp_path


@pytest.fixture()
def gpu_device():
    """The first GPU device; skips the test where there is none."""
    import jax
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a GPU (run with BODA_TEST_GPU=1 on a card)")
    return devs[0]


# ---- slow-test gating ----
# `pytest -q` is the tight default loop; tests marked slow run only with
# BODA_RUN_SLOW=1 (CI / pre-ship). Golden-cmd coverage of slow=1 entries
# is kept by `python -m boda_tpu test_all` (run_slow defaults on there).
def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: heavy test; skipped unless BODA_RUN_SLOW=1")
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skips (via the gpu_device fixture) "
                   "where there is none")


def pytest_collection_modifyitems(config, items):
    if os.environ.get("BODA_RUN_SLOW") == "1":
        return
    skip = pytest.mark.skip(reason="slow (set BODA_RUN_SLOW=1)")
    for it in items:
        if "slow" in it.keywords:
            it.add_marker(skip)
