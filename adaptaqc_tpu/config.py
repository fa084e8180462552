"""Global numeric configuration.

The reference (qiskit-community/adapt-aqc) runs float64/complex128 throughout
because Aer is a CPU C++ simulator. On an accelerator, 64-bit arithmetic is
slow; complex64 comfortably meets the default cost tolerance
(sufficient_cost=1e-2, /root/reference/adaptaqc/utils/constants.py:31). We
therefore derive the working dtypes from JAX's x64 flag: tests running on CPU
may enable x64 for high-precision oracle checks, while device runs default to
complex64.
"""

import os

import jax
import jax.numpy as jnp

# Persistent compilation cache: the engine programs are large (nested scans
# with SVDs) and can take minutes to compile cold; cache them across
# processes. JAX itself honours JAX_COMPILATION_CACHE_DIR; without it the
# cache sits at one fixed path inside the checkout (the path is part of the
# cache key, so it must not move between runs).
CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".jax_cache")
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


def real_dtype():
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def complex_dtype():
    return jnp.complex128 if jax.config.jax_enable_x64 else jnp.complex64


# Minimum singular value considered nonzero when inverting bond weights in
# the Vidal-form MPS update (Aer applies a similar regularisation
# internally). Must scale with the working precision: in f32, lambda values
# below ~10 * machine-eps are pure rounding noise and inverting them
# amplifies that noise into the Gamma tensors (observed as |<a|b>|^2 > 1
# norm drift over hundreds of 2q applies at 50q).
LAMBDA_EPS = 1e-12


def lambda_eps(dtype):
    import numpy as np
    return 1e-12 if np.dtype(dtype).itemsize >= 8 else 1e-6
