"""Test harness: force an 8-device virtual CPU mesh.

This is the JAX "fake backend" for multi-device tests (SURVEY.md §4): all
sharding/collective paths run on CPU without TPU hardware. jax is already
imported by the time conftest runs (pytest plugins pull it in), so env vars
are too late — but the backend initializes lazily, so jax.config still
takes effect here.
"""

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", False)

assert jax.default_backend() == "cpu", "tests must run on the virtual CPU mesh"
assert len(jax.devices()) == 8

collect_ignore_glob = []


def pytest_configure(config):
    import warnings

    # flax Variable `.value` deprecation fires on every weight-copy write in
    # the parity tests; torch emits size_average deprecations from the
    # reference package. Both are intentional usages.
    warnings.filterwarnings("ignore", message=".*'.value' access.*")
    warnings.filterwarnings("ignore", message=".*size_average.*")
    warnings.filterwarnings("ignore", message=".*reduce.*deprecated.*")
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card; skips without one")
