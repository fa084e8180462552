"""Multi-chip sharding for ADAPT-AQC.

The reference has no distributed runtime (SURVEY.md section 2.7): its only
parallelism is Aer's intra-simulator OpenMP threading plus fanning whole
compilations across processes. The device-native equivalents here:

 - dp axis — candidate-pair scoring (the per-layer heuristic sweep over the
   coupling map, O(n^2) pairs for CMAP_FULL) shards the pairs axis across
   devices; each device scores its pairs against a replicated state.
 - tp axis — the simulation state itself shards across devices: the 2^n
   statevector amplitude axis, or the MPS bond (chi) axis, letting
   compilations exceed one card's memory. Gate application under jit is
   partitioned by GSPMD: contractions over sharded axes lower to
   collectives between the cards.

Both axes compose in one `jax.sharding.Mesh`. Integration into the real
compiler goes through the backends: construct `SVBackend(mesh=...)` or
`MPSBackend(mesh=...)` and every engine state the compiler caches is
tp-sharded, so the O(G) Rotosolve/Rotoselect sweeps (optim/sweeps.py) and the
batched pair-RDM scoring run as GSPMD programs over the mesh with no
compiler-side changes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..backends import sv_core
from ..ops.cplx import C
from ..optim import sweeps


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Tuple[str, str] = ("dp", "tp"),
              shape: Optional[Tuple[int, int]] = None) -> Mesh:
    devices = jax.devices()
    n = n_devices or len(devices)
    if shape is None:
        # favour tp (state sharding) with a modest dp factor
        tp = 1
        while tp * 2 <= n and tp < 4:
            tp *= 2
        dp = n // tp
        shape = (dp, tp)
    mesh_devices = np.asarray(devices[:shape[0] * shape[1]]).reshape(shape)
    return Mesh(mesh_devices, axis_names)


def shard_state(mesh: Mesh, state: C, axis: str = "tp") -> C:
    """tp-shard a statevector C over its amplitude axis (replicates when the
    axis does not divide)."""
    if state.re.shape[0] % mesh.shape[axis] != 0:
        return replicate(mesh, state)
    sh = NamedSharding(mesh, P(axis))
    return C(jax.device_put(state.re, sh), jax.device_put(state.im, sh))


def shard_mps(mesh: Mesh, state, axis: str = "tp"):
    """tp-shard an MPS over its right-bond (chi) axis: gam (n, 2, chi, chi)
    on the last axis, lam (n+1, chi) on the last axis. chi**2-cost
    environment contractions then shard their matmuls over the mesh."""
    from ..backends import mps_core
    if state.chi % mesh.shape[axis] != 0:
        return replicate(mesh, state)
    b_sh = NamedSharding(mesh, P(None, None, None, axis))
    lam_sh = NamedSharding(mesh, P(None, axis))
    return mps_core.MPS(
        C(jax.device_put(state.b.re, b_sh),
          jax.device_put(state.b.im, b_sh)),
        jax.device_put(state.lam, lam_sh),
        jax.device_put(state.trunc, NamedSharding(mesh, P())))


def replicate(mesh: Mesh, x):
    # a single fully-replicated sharding applies to every pytree leaf
    return jax.device_put(x, NamedSharding(mesh, P()))


def shard_pairs(mesh: Mesh, pairs: np.ndarray, axis: str = "dp"):
    """dp-shard a (P, 2) coupling-map array, padding P up to a multiple of
    the dp extent. Returns (sharded_pairs, original_count)."""
    pairs = np.asarray(pairs, dtype=np.int32)
    n_pairs = len(pairs)
    dp = mesh.shape[axis]
    pad = (-n_pairs) % dp
    if pad:
        pairs = np.concatenate([pairs, np.tile(pairs[:1], (pad, 1))])
    return jax.device_put(jnp.asarray(pairs),
                          NamedSharding(mesh, P(axis, None))), n_pairs


def make_mps_training_step(mesh: Mesh, n: int, chi: int, padded_len: int,
                           threshold: float = 0.0, rotoselect: bool = True):
    """One jitted ADAPT optimisation step over the mesh for the MPS engine:
    a Rotoselect sweep on the chi-sharded MPS (every chi^3 bond contraction
    and Gram eigh partitions over the tp axis under GSPMD) followed by the
    all-pair 2-site RDM scoring pass on the swept state — the per-layer
    work the MPS compiler performs at 50q. The sharded path uses the
    GSPMD-partitionable XLA scan engine (the incremental env cache is a
    single-device program, backend.MPSBackend.sweep_engine).
    """
    from ..backends import mps_core
    engine = mps_core.sweep_engine(threshold, allow_env_cache=False)
    bl = sweeps.default_block_len(
        padded_len, sweeps.state_nbytes(mps_core.zero_mps(n, chi)))
    repl = NamedSharding(mesh, P())

    @jax.jit
    def step(prefix, kinds, q0, q1, angles, select):
        ref = mps_core.zero_mps(n, chi, prefix.lam.dtype)
        nk, na, cost, l_state, evals, _ov2 = sweeps.sweep(
            engine, bl, rotoselect, prefix, ref, kinds, q0, q1, angles,
            select)
        rhos = mps_core.all_pair_rdms(l_state)  # C (n, n, 4, 4)
        return nk, na, cost, l_state, rhos, evals

    def run(prefix, tape, select):
        prefix = shard_mps(mesh, prefix)
        args = [jax.device_put(jnp.asarray(x), repl)
                for x in (tape.kinds, tape.q0, tape.q1, tape.angles)]
        select = jax.device_put(jnp.asarray(select), repl)
        return step(prefix, *args, select)

    return run


def make_training_step(mesh: Mesh, n: int, padded_len: int,
                       rotoselect: bool = True):
    """One jitted ADAPT optimisation step over the mesh: a Rotoselect sweep
    on the tp-sharded statevector + dp-sharded all-pair 2-site RDMs — the
    exact quantities the ISL heuristic consumes (the concurrence
    post-processing of each 4x4 RDM stays host-side, as in
    utils/entanglement_measures.py)."""
    engine = sv_core.sweep_engine()
    bl = sweeps.default_block_len(padded_len)

    state_spec = NamedSharding(mesh, P("tp"))
    repl = NamedSharding(mesh, P())

    @jax.jit
    def step(prefix: C, kinds, q0, q1, angles, select, pairs):
        ref = sv_core.zero_state(n, prefix.dtype)
        nk, na, cost, l_state, evals, _ov2 = sweeps.sweep(
            engine, bl, rotoselect, prefix, ref, kinds, q0, q1, angles, select)
        rhos = sv_core.all_pair_rdms(l_state, pairs)  # C (P, 4, 4)
        return nk, na, cost, rhos, evals

    def run(prefix: C, tape, select, pairs):
        prefix = shard_state(mesh, prefix)
        args = [jax.device_put(jnp.asarray(x), repl)
                for x in (tape.kinds, tape.q0, tape.q1, tape.angles)]
        select = jax.device_put(jnp.asarray(select), repl)
        pairs, n_pairs = shard_pairs(mesh, pairs)
        nk, na, cost, rhos, evals = step(prefix, *args, select, pairs)
        return nk, na, cost, rhos[:n_pairs], evals

    return run
