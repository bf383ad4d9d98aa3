"""Test config: force the CPU backend with 8 virtual devices so multi-chip sharding
paths compile and execute without TPU hardware (the reference's fake-device CI pattern,
`test/custom_runtime/`)."""
import os

os.environ["XLA_FLAGS"] = os.environ.get("XLA_FLAGS", "") + \
    " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def pytest_configure(config):
    # tier-1 runs `-m "not slow"` (ROADMAP): 'slow' holds the compile-heavy
    # deep parallel-combo parity tests that would blow the tier-1 time budget
    config.addinivalue_line("markers", "slow: excluded from the tier-1 suite")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")
