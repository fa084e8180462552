"""On-device Rotosolve / Rotoselect sweep, generic over simulation engine.

This is the performance core of the library. The reference's hot loop
re-simulates the entire circuit 2-3 times per angle update
(/root/reference/adaptaqc/utils/cost_minimiser.py:344-368 ->
approximate_compiler.py:514-527), i.e. O(3*G^2) gate applications per sweep
over G gates. Here a sweep costs O(G) gate applications:

 - Left states L_k (gates < k applied to the cached prefix) advance
   incrementally during the forward sweep.
 - Right environments R_k = (U_{k+1}...U_G)^dagger |0..0> are produced by a
   block-checkpointed backward pass (sqrt-style: NB checkpoints + per-block
   regeneration), so memory is O((G/BL + BL) * state) instead of O(G * state).
 - For a rotation on qubit q, all probe costs follow from the 2x2 local
   overlap matrix C[i,j] = <R_k| (|i><j|_q) |L_{k-1}>: with
   z(theta) = cos(theta/2) * tr(C) - i sin(theta/2) * tr(P_axis C),
   cost(theta) = 1 - |z|^2. One local contraction replaces 3 (Rotosolve) or 7
   (Rotoselect) full re-simulations; the closed-form sinusoidal minimum
   (utilityfunctions.py:34-57) is evaluated on device.

Gate updates are sequential (exactly matching the reference's coordinate
descent: gate k's probes see gates < k already updated, gates > k at old
values), but each step is O(1) engine work instead of O(G).

The engine interface makes the same sweep work for the statevector and MPS
engines (and, in the multi-chip case, their sharded variants).
"""

from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..circuits import gates as G
from ..ops import cplx
from .sinusoidal import has_stopped_improving, minimum_of_sinusoidal_dev


class EnvOps(NamedTuple):
    """Optional incremental-environment support for `local_overlap`.

    An engine that can cache transfer environments between the sweep's R/L
    states exposes these three functions; the sweep then pays O(distance
    between consecutive probed sites) per probe instead of O(n) full-chain
    contractions (the dominant cost of window Rotosolve at large n).

      init(state) -> env                      fresh env for one sweep
      touch(env, t0, t1, active) -> env       invalidate after a gate
                                              touched sites [t0, t1]
      probe(env, r_state, l_state, q)
          -> (C 2x2, env)                     advance to q and contract
    """
    init: Callable[..., Any]
    touch: Callable[..., Any]
    probe: Callable[..., Any]


class SweepEngine(NamedTuple):
    """Pure functions the sweep needs from a simulation engine."""
    name: str
    # (state, kind, q0, q1, angle) -> state
    apply: Callable[..., Any]
    # (state, kind, q0, q1, angle) -> state   -- applies the gate's adjoint
    apply_adjoint: Callable[..., Any]
    # (r_state, l_state, q) -> complex 2x2  C[i,j] = <R| |i><j|_q |L>
    local_overlap: Callable[..., Any]
    # (a, b) -> complex  <a|b>
    overlap: Callable[..., Any]
    # optional EnvOps enabling incremental probe environments
    env_ops: Any = None
    # optional (state, ref) -> (global_cost, local_cost, hamming1_sum):
    # the probe cost kernel for the full-cost sweep (local / softened modes)
    cost_terms: Any = None


def _probe_and_update(engine, r_state, l_state, kind, q0, rotoselect: bool):
    """Closed-form best (kind, angle) for trainable gate k; returns
    (new_kind, new_angle, overlap2_best, n_evals)."""
    Cm = engine.local_overlap(r_state, l_state, q0)  # cplx.C 2x2
    return _best_from_overlap_matrix(Cm, kind, rotoselect)


def _best_from_overlap_matrix(Cm, kind, rotoselect: bool):
    """Closed-form best (kind, angle) from the 2x2 local overlap matrix.

    For U(theta) = cos(theta/2) I - i sin(theta/2) P_axis:
    z(theta) = cos(theta/2) tr(C) - i sin(theta/2) tr(P_axis C), with the
    2x2 local matrix C replacing the reference's 3 full re-simulations per
    probe. The probes MAXIMISE |z(theta)|^2 (itself a sinusoid in theta)
    rather than minimising 1 - |z|^2: at large n the overlap can sit far
    below float precision of 1 (e.g. |z| ~ 1e-6 for the 50q random-MPS
    workload), where the reference's cost form underflows to exactly 1.0
    in f32 and kills the optimisation signal, while |z|^2 ~ 1e-12 is
    perfectly representable.
    """
    t_i = Cm[0, 0] + Cm[1, 1]
    t_x = Cm[0, 1] + Cm[1, 0]
    t_y = (Cm[1, 0] - Cm[0, 1]).mul_i()
    t_z = Cm[0, 0] - Cm[1, 1]
    t_paulis = cplx.stack([t_x, t_y, t_z])

    ov2_0 = t_i.abs2()

    def axis_best(t_p):
        # theta = +-pi/2: z = (t_i -+ i t_p)/sqrt(2)
        ip = t_p.mul_i()
        ov2_p = (t_i - ip).abs2() * 0.5
        ov2_m = (t_i + ip).abs2() * 0.5
        theta, neg_max = minimum_of_sinusoidal_dev(-ov2_0, -ov2_p, -ov2_m)
        return theta, -neg_max

    if rotoselect:
        thetas, ov2s = jax.vmap(axis_best)(t_paulis)
        best = jnp.argmax(ov2s)
        new_kind = (G.RX + best).astype(kind.dtype)
        new_angle = thetas[best]
        ov2_best = ov2s[best]
        n_evals = jnp.int32(7)  # 1 identity + 2 per axis (cost_minimiser.py:318-342)
    else:
        axis = jnp.clip(kind - G.RX, 0, 2)
        theta, ov2_best = axis_best(t_paulis[axis])
        new_kind = kind
        new_angle = theta
        n_evals = jnp.int32(3)
    return new_kind, new_angle, ov2_best, n_evals


@functools.partial(jax.jit, static_argnums=(0, 1, 2))
def sweep(engine: SweepEngine, block_len: int, rotoselect: bool,
          prefix_state, ref_state, kinds, q0s, q1s, angles, select):
    """One Rotosolve/Rotoselect cycle over the tape. Returns
    (new_kinds, new_angles, final_cost, final_state, n_evals, final_ov2)
    where final_ov2 = |<ref|final>|^2 (cancellation-free; final_cost is
    1 - final_ov2 and pins at 1.0 in f32 once the overlap is tiny)."""
    Gp = kinds.shape[0]
    BL = min(block_len, Gp)
    assert Gp % BL == 0, f"padded tape length {Gp} not a multiple of {BL}"
    NB = Gp // BL

    def reshape_blocks(x):
        return x.reshape((NB, BL) + x.shape[1:])

    bk, bq0, bq1, bang = (reshape_blocks(x) for x in (kinds, q0s, q1s, angles))
    bsel = reshape_blocks(select)

    # ---- phase A: backward pass producing NB block checkpoints ------------
    # ckpts[b] = R state with adjoints of all gates in blocks > b applied,
    # i.e. R_upto[(b+1)*BL]. With a single block the only checkpoint is the
    # reference state itself — skip the pass (1/3 of all gate applies).
    if NB == 1:
        ckpts = jax.tree.map(lambda v: v[None], ref_state)
    else:
        def block_back(state, xs):
            ck = state

            def gate_back(s, x):
                k, a, b, th = x
                return engine.apply_adjoint(s, k, a, b, th), None

            rev = jax.tree.map(lambda v: jnp.flip(v, 0), xs)
            state, _ = lax.scan(gate_back, state, rev)
            return state, ck

        blocks_rev = jax.tree.map(lambda v: jnp.flip(v, 0),
                                  (bk, bq0, bq1, bang))
        _, cks = lax.scan(block_back, ref_state, blocks_rev)
        ckpts = jax.tree.map(lambda v: jnp.flip(v, 0), cks)  # ckpts[b]

    # ---- phase B: forward sweep -------------------------------------------
    # With EnvOps (MPS engine), probe environments advance incrementally:
    # O(site distance between consecutive probes) transfer steps instead of
    # one O(n) full-chain contraction per probe.
    use_env = engine.env_ops is not None
    env0 = engine.env_ops.init(prefix_state) if use_env else ()

    def block_fwd(carry, xs):
        l_state, ov2_last, evals, env = carry
        ck, xk, xq0, xq1, xang, xsel = xs

        # regenerate the BL right-states of this block from its checkpoint
        def gate_back(s, x):
            k, a, b, th = x
            return engine.apply_adjoint(s, k, a, b, th), s

        rev = jax.tree.map(lambda v: jnp.flip(v, 0), (xk, xq0, xq1, xang))
        _, r_rev = lax.scan(gate_back, ck, rev)
        r_buf = jax.tree.map(lambda v: jnp.flip(v, 0), r_rev)  # r_buf[i] = R for gate i

        def gate_fwd(c, x):
            l_state, ov2_last, evals, env = c
            k, a, b, th, sel, r_state = x

            if use_env:
                # sites touched by gate k: it moves BOTH states this step
                # (R_{k-1} -> R_k before the probe, L gains gate k after)
                is2q = ((k == G.CX) | (k == G.CZ) | (k == G.SWAP)
                        | (k >= G.N_KINDS))
                t1 = jnp.where(is2q, b, a)
                active = k != G.NOP
                env = engine.env_ops.touch(env, a, t1, active)
                # probe UNCONDITIONALLY (no-op frontiers when unselected):
                # only the 2x2 result crosses lax.cond — conditioning the
                # big env buffers would copy them at every gate step
                Cm, env = engine.env_ops.probe(env, r_state, l_state, a,
                                               sel)

                def probed(cm):
                    return _best_from_overlap_matrix(cm, k, rotoselect)

                def skipped(cm):
                    return k, th, ov2_last, jnp.int32(0)

                nk, na, ov2, ne = lax.cond(sel, probed, skipped, Cm)
                env = engine.env_ops.touch(env, a, t1, active)
            else:
                def probed():
                    return _probe_and_update(engine, r_state, l_state, k, a,
                                             rotoselect)

                def skipped():
                    return k, th, ov2_last, jnp.int32(0)

                nk, na, ov2, ne = lax.cond(sel, probed, skipped)
            l_state = engine.apply(l_state, nk, a, b, na)
            return (l_state, ov2, evals + ne, env), (nk, na)

        (l_state, ov2_last, evals, env), (nks, nas) = lax.scan(
            gate_fwd, (l_state, ov2_last, evals, env),
            (xk, xq0, xq1, xang, xsel, r_buf))
        return (l_state, ov2_last, evals, env), (nks, nas)

    init = (prefix_state, jnp.asarray(0.0, angles.dtype), jnp.int32(0), env0)
    (l_state, ov2_last, evals, _), (nks, nas) = lax.scan(
        block_fwd, init, (ckpts, bk, bq0, bq1, bang, bsel))

    new_kinds = nks.reshape(Gp)
    new_angles = nas.reshape(Gp)
    final_ov2 = engine.overlap(ref_state, l_state).abs2()
    final_cost = 1.0 - final_ov2
    return new_kinds, new_angles, final_cost, l_state, evals, final_ov2


# share of the device's memory limit the single-block R-state buffer may take
SWEEP_MEMORY_SHARE = 0.25
# budget where the device reports no memory limit (the CPU backend)
_FALLBACK_BUDGET = 4e9


def sweep_memory_budget() -> int:
    """Bytes the single-block R-state buffer may take: a fixed share of the
    default device's memory limit where it reports one."""
    stats = jax.devices()[0].memory_stats() or {}
    limit = stats.get("bytes_limit")
    return int(SWEEP_MEMORY_SHARE * limit) if limit else int(_FALLBACK_BUDGET)


def default_block_len(padded_len: int, state_bytes: int = None,
                      memory_budget: int = None) -> int:
    """Block size for the right-environment checkpointing.

    When the whole tape's R-state buffer fits in `memory_budget` bytes
    (default: sweep_memory_budget()), use ONE block: the backward checkpoint
    pass is then skipped entirely, cutting gate applies per sweep from 3G to
    2G. Otherwise fall back to the sqrt-style block size
    (O((G/BL + BL) * state) memory)."""
    if state_bytes:
        budget = memory_budget or sweep_memory_budget()
        if padded_len * state_bytes <= budget:
            return padded_len
    for bl in (32, 16, 8, 4, 2, 1):
        if padded_len % bl == 0 and bl * bl <= 4 * padded_len:
            return bl
    return 1


def state_nbytes(state) -> int:
    """Total bytes of one engine state pytree."""
    return sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(state))


def _stopped_improving_dev(hist3, rel_tol):
    """Device version of has_stopped_improving for a 3-cost window
    (utilityfunctions.py:272-278): linear-fit slope over |mean|."""
    slope = (hist3[2] - hist3[0]) / 2.0
    mean = jnp.abs(hist3[0] + hist3[1] + hist3[2]) / 3.0
    return slope / jnp.maximum(mean, 1e-30) > -rel_tol


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3))
def sweep_until_converged(engine: SweepEngine, block_len: int, rotoselect: bool,
                          max_cycles: int, prefix_state, ref_state, kinds,
                          q0s, q1s, angles, select, stop_val, tol,
                          init_state=()):
    """Run Rotosolve/Rotoselect cycles to convergence entirely on device.

    Replicates CostMinimiser.minimize_cost's cycle loop
    (cost_minimiser.py:90-105): evaluate the current cost, then sweep while
    cost > stop_val, cycles < max_cycles, and the optimisation still
    improves by `tol`. Improvement is tested on BOTH the cost history (the
    reference's criterion — sensitive near cost 0 where the overlap
    saturates) and the overlap^2 history (sensitive in the tiny-overlap
    regime where f32 cost pins at exactly 1.0): cycles continue while either
    signal is still moving. One host<->device round trip per minimize_cost
    call instead of one per cycle.

    `init_state` (optional): the engine state of prefix+tape at the input
    angles, when the caller already holds it (the compiler's full-state
    cache). Passing it skips the initial-cost re-simulation of the whole
    tape — with the reference-default schedule that pass is ~1/3 of a full
    sweep cycle (G gate applies incl. every bond SVD) per minimize_cost
    call. Pass () to have it computed here.

    Returns (kinds, angles, final_cost, cycles, evals, final_state, cost0):
    final_state is the engine state of prefix+tape at the returned angles —
    callers seed their full-state caches with it instead of re-simulating
    the tape (at 50q the re-simulation costs ~0.4 s of SVDs per layer).
    cost0 is the cost at the INPUT angles: coordinate-descent sweeps are
    monotone per probe in exact arithmetic, so a final cost above cost0
    signals numerical/device corruption — the minimiser's sweep guard
    restores the input angles instead of writing the result back (the
    reference optimiser's restore-on-fail behavior, cost_minimiser.py).
    """
    if isinstance(init_state, tuple) and init_state == ():
        # initial cost of the unmodified tape (the reference's leading
        # cost_finder() call)
        def apply_all(state, k, a, b, th):
            def body(s, x):
                return engine.apply(s, *x), None
            s, _ = lax.scan(body, state, (k, a, b, th))
            return s

        init_state = apply_all(prefix_state, kinds, q0s, q1s, angles)
    ov2_0 = engine.overlap(ref_state, init_state).abs2()
    cost0 = 1.0 - ov2_0

    big = jnp.asarray(1e30, angles.dtype)

    def cond(carry):
        k, a, cost, hist, ov2_hist, cycle, evals, state = carry
        not_done = (cost > stop_val) & (cycle < max_cycles)
        cost_stopped = _stopped_improving_dev(hist, tol)
        # overlap^2 grows when improving: stopped when relative growth < tol
        ov2_slope = (ov2_hist[2] - ov2_hist[0]) / 2.0
        ov2_mean = jnp.abs(ov2_hist[0] + ov2_hist[1] + ov2_hist[2]) / 3.0
        ov2_stopped = ov2_slope / jnp.maximum(ov2_mean, 1e-30) < tol
        improving = jnp.where(cycle > 3, ~(cost_stopped & ov2_stopped), True)
        return not_done & improving

    def body(carry):
        k, a, cost, hist, ov2_hist, cycle, evals, state = carry
        k, a, cost, state, ev, ov2 = sweep(engine, block_len, rotoselect,
                                           prefix_state, ref_state, k, q0s,
                                           q1s, a, select)
        hist = jnp.stack([hist[1], hist[2], cost])
        ov2_hist = jnp.stack([ov2_hist[1], ov2_hist[2], ov2])
        return (k, a, cost, hist, ov2_hist, cycle + 1, evals + ev, state)

    init = (kinds, angles, cost0, jnp.stack([big, big, big]),
            jnp.zeros(3, angles.dtype), jnp.int32(0), jnp.int32(1),
            init_state)
    (k, a, cost, hist, ov2_hist, cycles, evals,
     state) = lax.while_loop(cond, body, init)
    return k, a, cost, cycles, evals, state, cost0


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3))
def sweep_n_cycles(engine: SweepEngine, block_len: int, rotoselect: bool,
                   cycles: int, prefix_state, ref_state, kinds, q0s, q1s,
                   angles, select):
    """Exactly `cycles` sweeps fused into ONE device call (no convergence
    test) — the benchmarking / fixed-budget variant of
    sweep_until_converged. Returns (kinds, angles, final_cost, evals)."""
    def body(carry, _):
        k, a, evals = carry
        k, a, cost, _, ev, ov2 = sweep(engine, block_len, rotoselect,
                                       prefix_state, ref_state, k, q0s, q1s,
                                       a, select)
        return (k, a, evals + ev), cost

    (k, a, evals), costs = lax.scan(body, (kinds, angles, jnp.int32(0)),
                                    None, length=cycles)
    return k, a, costs[-1], evals


# --------------------------------------------------------------- zigzag mode
#
# Alternating-direction coordinate descent: the standard sweep pays 2G gate
# applies per cycle (a backward pass rebuilding every right state + the
# forward probe pass). In zigzag mode consecutive cycles alternate
# direction and REUSE the state buffer the previous cycle emitted:
#
#   forward cycle  k=0..G-1: probes read R_k from the buffer (written by the
#       previous backward cycle), the carried L advances through each
#       updated gate, and the PRE-apply L_{k-1} states are emitted;
#   backward cycle k=G-1..0: probes read L_{k-1} from the buffer, the
#       carried R advances through each updated gate's adjoint, and the
#       pre-apply R_k states are emitted.
#
# Each probe still sees every other gate at its most recent value (exact
# Gauss-Seidel/coordinate descent; the reference's fixed forward order is
# the default mode, zigzag is opt-in via CostMinimiser/env flag) — but a
# cycle costs G applies instead of 2G. Memory: one G-state buffer, the same
# footprint as the single-block right-state buffer of sweep().


def _zz_forward(engine, rotoselect, prefix_state, ref_state, xs, r_buf):
    """One forward probe cycle. xs = (kinds, q0s, q1s, angles, select).
    Returns (nk, na, ov2_final, l_final, evals, l_buf) where l_buf[k] is the
    pre-apply state L_{k-1} (what a backward cycle probes gate k with)."""
    def gate_fwd(c, x):
        l_state, evals = c
        (k, a, b, th, sel), r_state = x

        def probed():
            return _probe_and_update(engine, r_state, l_state, k, a,
                                     rotoselect)

        def skipped():
            return k, th, jnp.zeros((), th.dtype), jnp.int32(0)

        nk, na, _ov2, ne = lax.cond(sel, probed, skipped)
        pre = l_state
        l_state = engine.apply(l_state, nk, a, b, na)
        return (l_state, evals + ne), (nk, na, pre)

    (l_final, evals), (nks, nas, l_buf) = lax.scan(
        gate_fwd, (prefix_state, jnp.int32(0)), (xs, r_buf))
    ov2 = engine.overlap(ref_state, l_final).abs2()
    return nks, nas, ov2, l_final, evals, l_buf


def _zz_backward(engine, rotoselect, prefix_state, ref_state, xs, l_buf):
    """One backward probe cycle (gates G-1..0). Returns
    (nk, na, ov2_final, evals, r_buf) with r_buf[k] = R_k for the next
    forward cycle."""
    flip = lambda t: jax.tree.map(lambda v: jnp.flip(v, 0), t)

    def gate_bwd(c, x):
        r_state, evals = c
        (k, a, b, th, sel), l_pre = x

        def probed():
            return _probe_and_update(engine, r_state, l_pre, k, a,
                                     rotoselect)

        def skipped():
            return k, th, jnp.zeros((), th.dtype), jnp.int32(0)

        nk, na, _ov2, ne = lax.cond(sel, probed, skipped)
        pre = r_state
        r_state = engine.apply_adjoint(r_state, nk, a, b, na)
        return (r_state, evals + ne), (nk, na, pre)

    (r_final, evals), (nks_r, nas_r, r_buf_r) = lax.scan(
        gate_bwd, (ref_state, jnp.int32(0)), flip((xs, l_buf)))
    nks, nas, r_buf = flip((nks_r, nas_r, r_buf_r))
    # r_final = (U tape)^dagger |ref>; |<r_final|prefix>|^2 == |<ref|U|prefix>|^2
    ov2 = engine.overlap(r_final, prefix_state).abs2()
    return nks, nas, ov2, evals, r_buf


@functools.partial(jax.jit, static_argnums=(0, 1, 2))
def sweep_zigzag_until_converged(engine: SweepEngine, rotoselect: bool,
                                 max_cycles: int, prefix_state, ref_state,
                                 kinds, q0s, q1s, angles, select, stop_val,
                                 tol):
    """Zigzag variant of sweep_until_converged (single-block only).

    Runs (forward, backward) cycle pairs to convergence, then one final
    forward cycle so the returned state is the exact prefix+tape state at
    the returned angles. The initial backward R-state build also yields the
    initial cost, so no separate tape re-simulation is needed.

    Returns (kinds, angles, final_cost, cycles, evals, final_state, cost0)
    — cost0 as in sweep_until_converged (the minimiser's sweep guard)."""
    # initial R build at input angles: emits r_buf and the full adjoint
    # state, whose overlap with the prefix IS the initial cost
    flip = lambda t: jax.tree.map(lambda v: jnp.flip(v, 0), t)
    xs0 = (kinds, q0s, q1s, angles, select)

    def back(s, x):
        k, a, b, th, _sel = x
        pre = s
        return engine.apply_adjoint(s, k, a, b, th), pre

    r_final0, r_rev = lax.scan(back, ref_state, flip(xs0))
    r_buf0 = flip(r_rev)
    ov2_0 = engine.overlap(r_final0, prefix_state).abs2()
    cost0 = 1.0 - ov2_0

    big = jnp.asarray(1e30, angles.dtype)

    def cond(carry):
        k, a, cost, hist, ov2_hist, cycle, evals, buf = carry
        not_done = (cost > stop_val) & (cycle < max_cycles)
        cost_stopped = _stopped_improving_dev(hist, tol)
        ov2_slope = (ov2_hist[2] - ov2_hist[0]) / 2.0
        ov2_mean = jnp.abs(ov2_hist[0] + ov2_hist[1] + ov2_hist[2]) / 3.0
        ov2_stopped = ov2_slope / jnp.maximum(ov2_mean, 1e-30) < tol
        improving = jnp.where(cycle > 3, ~(cost_stopped & ov2_stopped), True)
        return not_done & improving

    def body(carry):
        k, a, cost, hist, ov2_hist, cycle, evals, r_buf = carry
        xs = (k, q0s, q1s, a, select)
        k, a, ov2_f, _lf, ev_f, l_buf = _zz_forward(
            engine, rotoselect, prefix_state, ref_state, xs, r_buf)
        xs = (k, q0s, q1s, a, select)
        k, a, ov2_b, ev_b, r_buf = _zz_backward(
            engine, rotoselect, prefix_state, ref_state, xs, l_buf)
        cost = 1.0 - ov2_b
        hist = jnp.stack([hist[1], hist[2], cost])
        ov2_hist = jnp.stack([ov2_hist[1], ov2_hist[2], ov2_b])
        return (k, a, cost, hist, ov2_hist, cycle + 2, evals + ev_f + ev_b,
                r_buf)

    init = (kinds, angles, cost0, jnp.stack([big, big, big]),
            jnp.zeros(3, angles.dtype), jnp.int32(0), jnp.int32(1), r_buf0)
    (k, a, cost, hist, ov2_hist, cycles, evals, r_buf) = lax.while_loop(
        cond, body, init)

    # final forward cycle: exact state at the returned angles (and one more
    # update round, which can only improve the cost)
    xs = (k, q0s, q1s, a, select)
    k, a, ov2_f, l_final, ev_f, _ = _zz_forward(
        engine, rotoselect, prefix_state, ref_state, xs, r_buf)
    return (k, a, 1.0 - ov2_f, cycles + 1, evals + ev_f, l_final, cost0)


# ------------------------------------------------------ full-cost probe sweep
#
# Device fast path for LOCAL-cost and SOFTENED-global-cost optimisation,
# where the probe cost is not a single overlap with a fixed reference (so the
# O(G) right-environment trick above does not apply). Semantics exactly mirror
# the reference's host loop (cost_minimiser.py:267-368): for each trainable
# gate, the cost is evaluated at the 3 probe angles {0, +pi/2, -pi/2}
# (Rotosolve) or the 7 axis probes (Rotoselect), each probe being a FULL
# simulation of the remaining circuit — but all probes of one angle run as a
# vmapped batch, the whole cycle is one fused device program (no host sync
# per probe), and the shared circuit prefix is advanced
# incrementally instead of re-simulated from scratch per probe. Cost per
# cycle is O(sum_k suffix_len(k)) ~ O(G^2/2) batched gate applies vs the
# reference's 3 * G full re-simulations of the ENTIRE circuit plus one host
# round trip per probe.
#
# The probe cost is a weighted combination of the engine's cost_terms:
#     cost = w_global * global + w_local * local - alpha * hamming1_sum
# (w_local=1 for optimise_local_cost, alpha=|prev_cost - sufficient_cost|
# for soften_global_cost — aer_mps_backend.py:49-74). Weights are traced
# scalars, so every mode shares one compiled program per tape shape.

_SOLVE_ANGLES = (0.0, jnp.pi / 2, -jnp.pi / 2)


def _probe_specs(rotoselect: bool, kind):
    """(probe_kinds, probe_angles) for one gate. Rotosolve: the gate's own
    axis at {0, +pi/2, -pi/2}. Rotoselect: identity probe (rx 0) + 2 probes
    per axis — the reference's 7 evaluations (cost_minimiser.py:318-342)."""
    if rotoselect:
        kinds = jnp.asarray([G.RX, G.RX, G.RX, G.RY, G.RY, G.RZ, G.RZ],
                            kind.dtype)
        angles = jnp.asarray([0.0, jnp.pi / 2, -jnp.pi / 2, jnp.pi / 2,
                              -jnp.pi / 2, jnp.pi / 2, -jnp.pi / 2])
    else:
        kinds = jnp.stack([kind, kind, kind])
        angles = jnp.asarray(_SOLVE_ANGLES)
    return kinds, angles


@functools.partial(jax.jit, static_argnums=(0, 1, 2))
def sweep_full_chunk(engine: SweepEngine, rotoselect: bool, chunk_len: int,
                     k_start, l_state_in, ref_state, kinds, q0s, q1s, angles,
                     select, weights):
    """Gates k_start .. k_start+chunk_len-1 of one full-cost cycle, as ONE
    bounded device call. A whole-tape cycle at padded G >= 512 is O(G^2/2)
    batched applies in a single execution — minutes of device wall. The
    host drives chunks, carrying the
    left state between calls; one compile serves every chunk of a given
    (tape bucket, chunk_len). Returns (kinds, angles, l_state_out, evals)."""
    Gp = kinds.shape[0]
    wg, wl, alpha = weights[0], weights[1], weights[2]

    def probe_cost(state):
        g, l, h1 = engine.cost_terms(state, ref_state)
        return wg * g + wl * l - alpha * h1

    apply_batch = jax.vmap(engine.apply, in_axes=(0, None, None, None, None))
    apply_probes = jax.vmap(engine.apply, in_axes=(None, 0, None, None, 0))

    def gate_step(carry, step_i):
        l_state, ks, angs, evals = carry
        k_idx = k_start + step_i
        k_idx = jnp.minimum(k_idx, Gp - 1)  # tail chunk: clamp, mask below
        kind = ks[k_idx]
        a, b = q0s[k_idx], q1s[k_idx]
        th = angs[k_idx]
        sel = select[k_idx] & (k_start + step_i < Gp)

        def probed(args):
            l_state, ks, angs = args
            pk, pa = _probe_specs(rotoselect, kind)
            probes = apply_probes(l_state, pk, a, b, pa)

            # evolve every probe through the suffix (gates j > k, at their
            # current values) — the masked scan is the full-circuit
            # re-simulation of the reference's probe, batched and fused
            def suf_step(states, x):
                jk, ja, jb, jth, j = x
                states = lax.cond(
                    j > k_idx,
                    lambda s: apply_batch(s, jk, ja, jb, jth),
                    lambda s: s, states)
                return states, None

            idx = jnp.arange(Gp, dtype=k_idx.dtype)
            probes, _ = lax.scan(suf_step, probes, (ks, q0s, q1s, angs, idx))
            costs = jax.vmap(probe_cost)(probes)

            if rotoselect:
                def axis_min(m):
                    return minimum_of_sinusoidal_dev(
                        costs[0], costs[1 + 2 * m], costs[2 + 2 * m])
                thetas, mins = jax.vmap(axis_min)(jnp.arange(3))
                best = jnp.argmin(mins)
                nk = (G.RX + best).astype(kind.dtype)
                return nk, thetas[best], jnp.int32(7)
            theta, _cmin = minimum_of_sinusoidal_dev(costs[0], costs[1],
                                                     costs[2])
            return kind, theta, jnp.int32(3)

        def skipped(args):
            return kind, th, jnp.int32(0)

        nk, na, ne = lax.cond(sel, probed, skipped, (l_state, ks, angs))
        ks = ks.at[k_idx].set(nk)
        angs = angs.at[k_idx].set(na)
        # tail chunk past Gp: k_idx is clamped to Gp-1, so re-applying would
        # corrupt the carried state — skip the apply entirely
        l_state = lax.cond(k_start + step_i < Gp,
                           lambda s: engine.apply(s, nk, a, b, na),
                           lambda s: s, l_state)
        return (l_state, ks, angs, evals + ne), None

    init = (l_state_in, kinds, angles, jnp.int32(0))
    (l_state, ks, angs, evals), _ = lax.scan(
        gate_step, init, jnp.arange(chunk_len, dtype=jnp.int32))
    return ks, angs, l_state, evals


def full_cost_of(engine: SweepEngine, ref_state, weights, state):
    """The weighted probe cost of a state (jitted per engine)."""
    g, l, h1 = engine.cost_terms(state, ref_state)
    return weights[0] * g + weights[1] * l - weights[2] * h1


_full_cost_jit = jax.jit(full_cost_of, static_argnums=(0,))


def sweep_full_chunked_until_converged(engine: SweepEngine, rotoselect: bool,
                                       max_cycles: int, prefix_state,
                                       ref_state, kinds, q0s, q1s, angles,
                                       select, stop_val, tol, weights,
                                       call_budget: int = 32768,
                                       init_state=()):
    """Host-driven full-cost convergence loop over bounded device calls.

    Mirrors sweep_full_until_converged's stopping semantics (stop_val,
    cycle budget, 3-window improvement test) but each device execution
    processes only `chunk` gates of the cycle, sized so one call performs
    ~call_budget batched gate applies — the whole-cycle fused program at
    padded G >= 512 runs minutes in one execution (see sweep_full_chunk).
    Cost per cycle is identical; the added wall is one host sync per
    chunk.

    Returns (kinds, angles, final_cost, cycles, evals, final_state, cost0)
    — cost0 as in sweep_until_converged (the minimiser's sweep guard).
    When the caller holds a valid full-state cache (prefix+tape at the
    input angles) it passes it as `init_state` and the probe-free tape
    pass (~1/2 cycle of applies, plus Gp/chunk host syncs) that would
    otherwise derive cost0 is skipped; `()` means no cache."""
    Gp = int(kinds.shape[0])
    chunk = max(16, min(Gp, call_budget // max(Gp, 1)))
    if not (isinstance(init_state, tuple) and init_state == ()):
        l0 = init_state
    else:
        no_probe = jnp.zeros_like(select)
        l0 = prefix_state
        for k0 in range(0, Gp, chunk):
            _, _, l0, _ = sweep_full_chunk(
                engine, rotoselect, chunk, jnp.int32(k0), l0, ref_state,
                kinds, q0s, q1s, angles, no_probe, weights)
    cost0 = float(_full_cost_jit(engine, ref_state, jnp.asarray(weights), l0))
    big = float("inf")
    hist = [big, big, big]
    evals = 0
    cost = None
    cycles = 0
    final_state = None
    for cycle in range(int(max_cycles)):
        l_state = prefix_state
        for k0 in range(0, Gp, chunk):
            kinds, angles, l_state, ev = sweep_full_chunk(
                engine, rotoselect, chunk, jnp.int32(k0), l_state, ref_state,
                kinds, q0s, q1s, angles, select, weights)
            evals += int(ev)
        final_state = l_state
        cost = float(_full_cost_jit(engine, ref_state,
                                    jnp.asarray(weights), l_state))
        cycles = cycle + 1
        hist = [hist[1], hist[2], cost]
        if cost <= float(stop_val):
            break
        if cycles > 3 and has_stopped_improving(list(hist), float(tol)):
            break
    return (kinds, angles, jnp.asarray(cost, angles.dtype), cycles, evals,
            final_state, cost0)


@functools.partial(jax.jit, static_argnums=(0, 1))
def sweep_full(engine: SweepEngine, rotoselect: bool, prefix_state, ref_state,
               kinds, q0s, q1s, angles, select, weights):
    """One whole-tape full-cost Rotosolve/Rotoselect cycle (fused). `weights`
    = (w_global, w_local, alpha). Returns (new_kinds, new_angles, final_cost,
    final_state, n_evals). For padded tapes >= 512 entries use the chunked
    host loop instead — one fused cycle is minutes of device wall."""
    Gp = kinds.shape[0]
    ks, angs, l_state, evals = sweep_full_chunk(
        engine, rotoselect, Gp, jnp.int32(0), prefix_state, ref_state,
        kinds, q0s, q1s, angles, select, weights)
    final_cost = full_cost_of(engine, ref_state, weights, l_state)
    return ks, angs, final_cost, l_state, evals


@functools.partial(jax.jit, static_argnums=(0, 1, 2))
def sweep_full_until_converged(engine: SweepEngine, rotoselect: bool,
                               max_cycles: int, prefix_state, ref_state,
                               kinds, q0s, q1s, angles, select, stop_val,
                               tol, weights, init_state=()):
    """Full-cost cycles to convergence in one device call. Stopping mirrors
    the reference's host loop (cost_minimiser.py:90-105): cost > stop_val,
    cycle budget, and the 3-window relative-slope improvement test on the
    cost history only (local / softened costs do not saturate at 1.0 the way
    the tiny-overlap global cost does, so no ov^2 channel is needed).

    Returns (kinds, angles, final_cost, cycles, evals, final_state)."""
    wg, wl, alpha = weights[0], weights[1], weights[2]

    def full_cost(state):
        g, l, h1 = engine.cost_terms(state, ref_state)
        return wg * g + wl * l - alpha * h1

    if isinstance(init_state, tuple) and init_state == ():
        def body(s, x):
            return engine.apply(s, *x), None

        init_state, _ = lax.scan(body, prefix_state,
                                 (kinds, q0s, q1s, angles))
    cost0 = full_cost(init_state)

    big = jnp.asarray(1e30, angles.dtype)

    def cond(carry):
        k, a, cost, hist, cycle, evals, state = carry
        not_done = (cost > stop_val) & (cycle < max_cycles)
        improving = jnp.where(cycle > 3,
                              ~_stopped_improving_dev(hist, tol), True)
        return not_done & improving

    def body(carry):
        k, a, cost, hist, cycle, evals, state = carry
        k, a, cost, state, ev = sweep_full(engine, rotoselect, prefix_state,
                                           ref_state, k, q0s, q1s, a, select,
                                           weights)
        hist = jnp.stack([hist[1], hist[2], cost])
        return (k, a, cost, hist, cycle + 1, evals + ev, state)

    init = (kinds, angles, cost0, jnp.stack([big, big, big]), jnp.int32(0),
            jnp.int32(1), init_state)
    (k, a, cost, hist, cycles, evals, state) = lax.while_loop(cond, body,
                                                              init)
    return k, a, cost, cycles, evals, state


@functools.partial(jax.jit, static_argnums=(0, 1, 2))
def sweep_zigzag_n_cycles(engine: SweepEngine, rotoselect: bool, pairs: int,
                          prefix_state, ref_state, kinds, q0s, q1s, angles,
                          select):
    """Exactly `pairs` (forward, backward) zigzag cycle pairs fused into one
    device call — the benchmarking variant of sweep_zigzag_until_converged.
    Total update cycles = 2*pairs; total gate applies = (2*pairs + 1) * G
    vs the standard sweep's 2 * (2*pairs) * G. Returns
    (kinds, angles, final_cost, evals)."""
    flip = lambda t: jax.tree.map(lambda v: jnp.flip(v, 0), t)

    def back(s, x):
        k, a, b, th, _sel = x
        pre = s
        return engine.apply_adjoint(s, k, a, b, th), pre

    _, r_rev = lax.scan(back, ref_state, flip((kinds, q0s, q1s, angles,
                                               select)))
    r_buf0 = flip(r_rev)

    def body(carry, _):
        k, a, evals, r_buf = carry
        xs = (k, q0s, q1s, a, select)
        k, a, ov2_f, _lf, ev_f, l_buf = _zz_forward(
            engine, rotoselect, prefix_state, ref_state, xs, r_buf)
        xs = (k, q0s, q1s, a, select)
        k, a, ov2_b, ev_b, r_buf = _zz_backward(
            engine, rotoselect, prefix_state, ref_state, xs, l_buf)
        return (k, a, evals + ev_f + ev_b, r_buf), ov2_b

    (k, a, evals, _), ov2s = lax.scan(body, (kinds, angles, jnp.int32(0),
                                             r_buf0), None, length=pairs)
    return k, a, 1.0 - ov2s[-1], evals
