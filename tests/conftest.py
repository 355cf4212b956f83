import jax
import pytest

# Tests run on the single host CPU device (the 512-device fleet exists only
# inside launch/dryrun.py).  Multi-device sharding tests spawn subprocesses
# with their own XLA_FLAGS.
jax.config.update("jax_platform_name", "cpu")


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="run tests marked slow (multi-device subprocess parity runs)")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: slow multi-device subprocess test, skipped unless --runslow "
        "(CI runs them; tier-1 stays fast)")
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card (skips with a reason on CPU-only hosts)")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip_slow = pytest.mark.skip(reason="slow subprocess test: use --runslow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip_slow)


@pytest.fixture(scope="session")
def rng_key():
    return jax.random.PRNGKey(0)


@pytest.fixture
def fixed_seed() -> int:
    """Deflaking seam for seed-sensitive serving tests: one fixed seed, so
    workload generation is identical across runs and machines."""
    return 1234
