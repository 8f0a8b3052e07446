import jax
import pytest

# Smoke tests and benches must see the single real CPU device — the 512
# placeholder devices are set ONLY inside repro.launch.dryrun.
assert "xla_force_host_platform_device_count" not in str(
    __import__("os").environ.get("XLA_FLAGS", ""))

jax.config.update("jax_enable_x64", False)

# Deterministic hypothesis runs: derandomize so CI failures reproduce
# locally from the seed printed in the failure, never from a lucky
# shrink. Registered here (not in the test modules) so every
# hypothesis-marked suite shares one profile; a no-op when the package
# is absent (tests/test_properties.py gates on that).
try:
    from hypothesis import HealthCheck, settings

    settings.register_profile(
        "repro", derandomize=True, deadline=None, max_examples=25,
        suppress_health_check=[HealthCheck.too_slow])
    settings.load_profile("repro")
except ImportError:
    pass


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips without one")


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)
