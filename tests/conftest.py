import os

# The suite runs on the CPU backend with 8 virtual devices (SURVEY.md §4
# test plan): fast, deterministic, and the same on every machine.  Both
# variables must be set before jax is first imported.  Tests marked
# ``gpu`` need an NVIDIA card and skip elsewhere; on a machine with one,
# run them with ``JAX_PLATFORMS=cuda python -m pytest tests -m gpu``.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU backend; skips elsewhere")


@pytest.fixture(autouse=True)
def _skip_gpu_tests_without_a_card(request):
    # decided per test, at run time, so every xdist worker collects the
    # same tests whatever backend it finds
    if (request.node.get_closest_marker("gpu") is not None
            and jax.default_backend() != "gpu"):
        pytest.skip("needs an NVIDIA GPU: run with "
                    "JAX_PLATFORMS=cuda python -m pytest tests -m gpu")
