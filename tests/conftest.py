import os

# Tests always run on CPU with a virtual 8-device mesh so multi-card sharding
# paths can be exercised without a GPU. Must be set before jax import.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# jax may already be imported (and have read JAX_PLATFORMS) before conftest
# runs — set the platform via config as well.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
