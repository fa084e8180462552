"""CostMinimiser: angle optimisation over the variational range.

API mirror of /root/reference/adaptaqc/utils/cost_minimiser.py. The
Rotosolve/Rotoselect path dispatches to the on-device O(G) sweep
(optim/sweeps.py) when the backend supports it; parameterised-gate circuits
('#'/'@' labels), local-cost and softened-cost optimisation fall back to a
host loop that reproduces the reference's per-gate 3-point probing against
`evaluate_cost` (each probe = one device call).

Generic optimisers: scipy is first-class; nlopt / pybobyqa are used when
installed and otherwise fall back to scipy equivalents with a warning (they
are not available in this environment).
"""

from __future__ import annotations

import logging
import os
import random
from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np
from scipy.optimize import minimize

from ..circuits import gates as G
from ..circuits import operations as co
from ..circuits.tape import compile_tape, select_mask, writeback_angles
from ..utils import constants as vconstants
from .sinusoidal import (derivative_of_sinusoidal, has_stopped_improving,
                         minimum_of_sinusoidal)
from . import sweeps

logger = logging.getLogger(__name__)

# per-device-call gate-apply budget for the chunked convergence loops: one
# fused whole-history call at warm-start tape sizes runs minutes of device
# wall in a single execution (sweep cycles are ~2*G applies each); chunking
# bounds each call. Re-tuning the budget on the GPU is open work.
_CALL_BUDGET = int(os.environ.get("ADAPTAQC_SWEEP_CALL_BUDGET", 32768))


def _sweep_went_backwards(cost: float, cost0: float) -> bool:
    """Sweep guard predicate: coordinate-descent sweeps are monotone per
    probe in exact arithmetic, so a final cost meaningfully ABOVE the
    input-angle cost can only be numerical or device corruption (observed
    once with an eigh implementation that had a real-workload bug: it
    silently destroyed 0.98-overlap warm starts). The
    tolerance absorbs legitimate f32/truncation-order jitter near
    convergence (chi-capped in-loop costs fluctuate ~1e-3); the 2e-3 floor
    keeps the guard tight where the near-miss seeds live (a 0.02 warm
    start regressing to 0.039 is rejected, not absorbed). Written in
    not-(accept) form so a NaN cost — a likely signature of the device
    fault class this guard exists for — fails CLOSED (rejected)."""
    return not (cost <= cost0 + max(2e-3, 0.10 * cost0))


class CostMinimiser:
    """Minimizer that minimizes a cost function (cost_minimiser.py:32)."""

    def __init__(self, cost_finder, variational_circuit_range, compiler,
                 rotosolve_fraction=1.0, zigzag=None):
        self.cost_finder = cost_finder
        self.variational_circuit_range = variational_circuit_range
        self.compiler = compiler
        self.rotosolve_fraction = rotosolve_fraction
        # alternating-direction sweep cycles (G applies/cycle instead of
        # 2G). Exact coordinate descent, but a different gate-visit order
        # than the reference's fixed forward sweeps — opt-in (also via env
        # ADAPTAQC_ZIGZAG=1) to preserve reference trajectories by default.
        if zigzag is None:
            zigzag = bool(int(os.environ.get("ADAPTAQC_ZIGZAG", "0")))
        self.zigzag = zigzag

    @property
    def full_circuit(self):
        return self.compiler.full_circuit

    # ------------------------------------------------------------- dispatch
    def minimize_cost(self, algorithm_kind=vconstants.ALG_ROTOSOLVE,
                      algorithm_identifier=None, max_cycles=1000,
                      stop_val=-np.inf, tol=1e-10, indexes_to_modify=None,
                      alg_kwargs=None, force_global=False):
        """force_global=True optimises the plain global overlap cost even
        when the compiler is in local/softened mode — the hybrid schedule's
        periodic consolidation pass (adapt_compiler global_polish)."""
        if alg_kwargs is None:
            alg_kwargs = {}
        if algorithm_kind in (vconstants.ALG_ROTOSOLVE, vconstants.ALG_ROTOSELECT):
            rotoselect = algorithm_kind == vconstants.ALG_ROTOSELECT
            if self._can_fast_sweep(force_global=force_global):
                return self._roto_device(rotoselect, max_cycles, stop_val, tol,
                                         indexes_to_modify)
            if self._can_full_sweep(rotoselect):
                return self._roto_device_full(rotoselect, max_cycles,
                                              stop_val, tol,
                                              indexes_to_modify)
            return self._roto_host(rotoselect, max_cycles, stop_val, tol,
                                   indexes_to_modify)
        elif algorithm_kind == vconstants.ALG_SCIPY:
            return self._scipy_minimize(algorithm_identifier, tol, alg_kwargs)
        elif algorithm_kind == vconstants.ALG_NLOPT:
            return self._nlopt_minimize(algorithm_identifier, stop_val, tol)
        elif algorithm_kind == vconstants.ALG_PYBOBYQA:
            return self._pybobyqa_minimize(alg_kwargs)
        raise ValueError(f"Invalid algorithm kind {algorithm_kind}")

    def _reject_sweep(self, alg_name: str, cost: float, cost0: float) -> float:
        """Restore-on-fail (reference CostMinimiser behavior): the sweep
        result is discarded — no angle writeback, so full_circuit and any
        valid state cache still describe the INPUT angles — and the
        input-angle cost is returned so the adapt loop's patience machinery
        sees an unimproving layer instead of inheriting a corrupted state."""
        logger.warning(
            f"{alg_name} sweep ended at cost {cost:.6f}, WORSE than its "
            f"starting cost {cost0:.6f} — numerically impossible for a "
            f"coordinate-descent sweep; discarding the sweep result "
            f"(device/numeric fault guard)")
        return float(cost0)

    # ------------------------------------------------------ device fast path
    def _can_fast_sweep(self, force_global=False) -> bool:
        comp = self.compiler
        if ((comp.optimise_local_cost or comp.soften_global_cost)
                and not force_global):
            return False
        if comp.backend.sweep_engine() is None:
            return False
        rng = self.variational_circuit_range()
        for i in range(rng[0], len(self.full_circuit.data)):
            lbl = self.full_circuit.data[i].label
            if lbl is not None and ("#" in lbl or "@" in lbl):
                return False
        return True

    def _can_full_sweep(self, rotoselect) -> bool:
        """Device path for local-cost / softened-cost optimisation: the probe
        cost is not a single overlap, so the O(G) environment sweep does not
        apply, but the reference's full-simulation probes
        (cost_minimiser.py:267-368) fuse into one device program
        (sweeps.sweep_full)."""
        comp = self.compiler
        if not (comp.optimise_local_cost or comp.soften_global_cost):
            return False
        if not (self.rotosolve_fraction >= 1.0 or rotoselect):
            return False  # per-cycle gate subsampling stays on the host path
        engine = comp.backend.sweep_engine()
        if engine is None or engine.cost_terms is None:
            return False
        rng = self.variational_circuit_range()
        for i in range(rng[0], len(self.full_circuit.data)):
            lbl = self.full_circuit.data[i].label
            if lbl is not None and ("#" in lbl or "@" in lbl):
                return False
        return True

    def _cost_weights(self):
        """(w_global, w_local, alpha) for the full-cost sweep, mirroring the
        backend cost layer: local cost when optimise_local_cost
        (aer_mps_backend.py:72-74), else global with the softening penalty
        alpha = |previous_cost - sufficient_cost| (:49-70; alpha is constant
        within one minimize_cost call since the cost history only grows
        between layers)."""
        comp = self.compiler
        if comp.optimise_local_cost:
            return (0.0, 1.0, 0.0)
        alpha = 0.0
        if comp.soften_global_cost:
            previous_cost = (comp.global_cost_history[-1]
                             if len(comp.global_cost_history) > 0 else 1)
            alpha = abs(previous_cost - comp.adapt_config.sufficient_cost)
        return (1.0, 0.0, float(alpha))

    def _roto_device_full(self, rotoselect, max_cycles, stop_val, tol,
                          indexes_to_modify):
        comp = self.compiler
        alg_name = "ROTOSELECT" if rotoselect else "ROTOSOLVE"
        var_range = self.variational_circuit_range()
        if indexes_to_modify is None:
            indexes_to_modify = var_range
        else:
            indexes_to_modify = (max(indexes_to_modify[0], var_range[0]),
                                 min(indexes_to_modify[1], var_range[1]))

        prefix = comp._prefix_state()
        tape_start = var_range[0]
        hint = getattr(comp, "_advance_hint", None)
        comp._advance_hint = None
        if indexes_to_modify[0] > tape_start:
            if hint is not None and hint[0] == indexes_to_modify[0]:
                prefix = hint[1]
            else:
                pre_tape = compile_tape(self.full_circuit,
                                        (tape_start, indexes_to_modify[0]))
                prefix = comp.backend.run_tape(prefix, pre_tape)
            tape_start = indexes_to_modify[0]

        tape_range = (tape_start, len(self.full_circuit.data))
        tape = compile_tape(self.full_circuit, tape_range)
        base_indices = [i - tape_range[0] for i in range(*indexes_to_modify)]
        full_mask = select_mask(tape, base_indices)

        ref = comp.backend.zero_ref(comp)
        engine = comp.backend.sweep_engine()
        kinds = jnp.asarray(tape.kinds)
        angles = jnp.asarray(tape.angles)
        q0 = jnp.asarray(tape.q0)
        q1 = jnp.asarray(tape.q1)
        dt = angles.dtype
        weights = jnp.asarray(self._cost_weights(), dt)

        logger.info(f"Starting {alg_name} (full-cost device path, chunked)")
        # host-driven chunked cycles: one fused whole-history program
        # (sweep_full_until_converged) runs O(cycles * G^2/2) applies in a
        # SINGLE device execution — minutes of wall at padded G >= 512.
        # The full-state cache, when valid, IS prefix+tape at the input
        # angles: hand it over so the chunked loop skips the probe-free
        # cost0 tape pass (~G applies + Gp/chunk host syncs per layer)
        init_state = comp._current_cache
        init_state = () if init_state is None else init_state
        (kinds, angles, cost_dev, cycles, evals, final_state,
         cost0) = sweeps.sweep_full_chunked_until_converged(
            engine, rotoselect, int(max_cycles), prefix, ref, kinds, q0, q1,
            angles, jnp.asarray(full_mask), jnp.asarray(stop_val, dt),
            jnp.asarray(tol, dt), weights, init_state=init_state)
        comp.cost_evaluation_counter += int(evals)
        cost = float(cost_dev)
        logger.info(f"{alg_name} ran {int(cycles)} full-cost cycles on device")
        if _sweep_went_backwards(cost, float(cost0)):
            return self._reject_sweep(alg_name, cost, float(cost0))
        writeback_angles(self.full_circuit, tape_range, tape,
                         np.asarray(kinds), np.asarray(angles))
        comp._invalidate_current()
        comp._current_cache = final_state
        logger.info(f"{alg_name} finished with cost {cost}")
        return cost

    def _roto_device(self, rotoselect, max_cycles, stop_val, tol,
                     indexes_to_modify):
        comp = self.compiler
        alg_name = "ROTOSELECT" if rotoselect else "ROTOSOLVE"
        var_range = self.variational_circuit_range()
        if indexes_to_modify is None:
            indexes_to_modify = var_range
        else:
            indexes_to_modify = (max(indexes_to_modify[0], var_range[0]),
                                 min(indexes_to_modify[1], var_range[1]))

        prefix = comp._prefix_state()
        # Gates left of the modify window are fixed for the whole call:
        # advance the prefix past them ONCE instead of re-applying them in
        # every sweep cycle. With the reference-default schedule
        # (rotosolve_frequency=1, max_layers_to_modify=100) the per-layer
        # Rotoselect would otherwise re-simulate ~100 frozen layers per
        # cycle to optimise the ~7 new gates. When the compiler stashed an
        # advance hint (the state up to the modify window, peeled from its
        # full-state cache), even that single advance pass is skipped.
        tape_start = var_range[0]
        hint = getattr(comp, "_advance_hint", None)
        comp._advance_hint = None
        if indexes_to_modify[0] > tape_start:
            if hint is not None and hint[0] == indexes_to_modify[0]:
                prefix = hint[1]
            else:
                pre_tape = compile_tape(self.full_circuit,
                                        (tape_start, indexes_to_modify[0]))
                prefix = comp.backend.run_tape(prefix, pre_tape)
            tape_start = indexes_to_modify[0]

        # tape covers the modify window + fixed rhs gates (suffix)
        tape_range = (tape_start, len(self.full_circuit.data))
        tape = compile_tape(self.full_circuit, tape_range)
        base_indices = [i - tape_range[0]
                        for i in range(*indexes_to_modify)]
        full_mask = select_mask(tape, base_indices)

        ref = comp.backend.zero_ref(comp)
        engine = comp.backend.sweep_engine()
        bl = sweeps.default_block_len(tape.padded_length,
                                      sweeps.state_nbytes(prefix))

        kinds = jnp.asarray(tape.kinds)
        angles = jnp.asarray(tape.angles)
        q0 = jnp.asarray(tape.q0)
        q1 = jnp.asarray(tape.q1)

        logger.info(f"Starting {alg_name}")
        final_state = None
        if self.rotosolve_fraction >= 1.0 or rotoselect:
            # fully fused: all cycles + convergence checks in ONE device call
            dt = angles.dtype
            use_zigzag = (self.zigzag and bl >= tape.padded_length
                          and engine.env_ops is None)
            cost0 = None
            if use_zigzag:
                # alternating-direction cycles reuse the state buffer the
                # previous cycle emitted: G applies per cycle instead of 2G
                (kinds, angles, cost_dev, cycles, evals,
                 final_state, c0) = sweeps.sweep_zigzag_until_converged(
                    engine, rotoselect, int(max_cycles), prefix, ref, kinds,
                    q0, q1, angles, jnp.asarray(full_mask),
                    jnp.asarray(stop_val, dt), jnp.asarray(tol, dt))
                cost0 = float(c0)
            else:
                # the full-state cache, when valid, IS prefix+tape at the
                # input angles: hand it over so the fused loop skips its
                # initial-cost re-simulation of the tape (G applies incl.
                # every bond SVD)
                init_state = comp._current_cache
                init_state = () if init_state is None else init_state
                # bound single device executions: the fused
                # sweep_until_converged runs ALL cycles in one call — at
                # warm-start tapes (G ~ 4000) that is minutes of device
                # wall. Chunk cycles so one call performs
                # ~CALL_BUDGET gate applies; the update sequence is
                # identical (cycles depend only on carried angles/state),
                # only the stop test gains a host-side view between chunks.
                Gp = int(kinds.shape[0])
                # fixed static chunk so every call of a tape bucket shares
                # one compile (a varying remainder would retrace per value)
                chunk = max(1, min(int(max_cycles),
                                   _CALL_BUDGET // max(2 * Gp, 1)))
                cycles = 0
                evals = 0
                hist = []
                cost_dev = None
                best = None  # (cost, kinds, angles, state) best chunk end
                while cycles < int(max_cycles):
                    (kinds, angles, cost_dev, ccyc, cevals,
                     final_state, c0) = sweeps.sweep_until_converged(
                        engine, bl, rotoselect, chunk, prefix, ref,
                        kinds, q0, q1, angles, jnp.asarray(full_mask),
                        jnp.asarray(stop_val, dt), jnp.asarray(tol, dt),
                        init_state)
                    if cost0 is None:
                        cost0 = float(c0)
                    init_state = final_state
                    cycles += int(ccyc)
                    evals += int(cevals)
                    hist.append(float(cost_dev))
                    # NaN-safe: a NaN chunk endpoint must never become the
                    # sticky best (NaN < x is False forever) — skip it and
                    # let the backwards-guard reject the sweep if nothing
                    # healthy follows
                    c = float(cost_dev)
                    if c == c and (best is None or c < best[0]):
                        best = (c, kinds, angles, final_state)
                    if int(ccyc) < chunk:  # converged inside the chunk
                        break
                    if float(cost_dev) <= float(stop_val):
                        break
                    if len(hist) > 3 and has_stopped_improving(
                            hist[-3:], tol):
                        break
                if best is not None:
                    # corruption can set in mid-loop (a degrading device):
                    # keep the best chunk endpoint, not the last
                    _, kinds, angles, final_state = best
                    cost_dev = best[0]
            comp.cost_evaluation_counter += int(evals)
            cost = float(cost_dev)
            logger.info(f"{alg_name} ran {int(cycles)} cycles on device")
            if cost0 is not None and _sweep_went_backwards(cost, cost0):
                return self._reject_sweep(alg_name, cost, cost0)
        else:
            # per-cycle host loop (rotosolve_fraction re-samples gates each cycle)
            cost = self.cost_finder()
            cycles = 0
            cost_history = []
            while cost > stop_val and cycles < max_cycles:
                mask = self._cycle_mask(tape, full_mask, base_indices, rotoselect)
                kinds, angles, cost_dev, final_state, evals, _ov2 = sweeps.sweep(
                    engine, bl, rotoselect, prefix, ref, kinds, q0, q1, angles,
                    jnp.asarray(mask))
                comp.cost_evaluation_counter += int(evals)
                cost = float(cost_dev)
                cycles += 1
                logger.info(f"{alg_name} cycle: {cycles}")
                cost_history.append(cost)
                if len(cost_history) > 3 and has_stopped_improving(
                        cost_history[-3:], tol):
                    break
        writeback_angles(self.full_circuit, tape_range, tape,
                         np.asarray(kinds), np.asarray(angles))
        comp._invalidate_current()
        if final_state is not None:
            # the sweep's final state IS the state of the whole full_circuit
            # at the written-back angles (the tape ran through the rhs
            # suffix): seed the cache so state_of()/pair scoring do not
            # re-simulate the unabsorbed tape — at 50q that re-simulation
            # is ~200 bond SVDs (~0.4 s) per layer
            comp._current_cache = final_state
        logger.info(f"{alg_name} finished with cost {cost}")
        return cost

    def _cycle_mask(self, tape, full_mask, base_indices, rotoselect):
        """Per-cycle rotosolve_fraction subsampling (cost_minimiser.py:293-302)."""
        if self.rotosolve_fraction >= 1.0 or rotoselect:
            return full_mask
        rotation_local = [i for i in base_indices
                          if tape.data_index_map[i][1] == 1
                          and tape.trainable[tape.data_index_map[i][0]]]
        num = int(np.ceil(self.rotosolve_fraction * len(rotation_local)))
        sample = random.sample(rotation_local, num)
        return select_mask(tape, sorted(sample))

    # ------------------------------------------------------- host slow path
    def _roto_host(self, rotoselect, max_cycles, stop_val, tol,
                   indexes_to_modify):
        alg_name = "ROTOSELECT" if rotoselect else "ROTOSOLVE"
        cost_history = []
        cost = self.cost_finder()
        cycles = 0
        logger.info(f"Starting {alg_name} (host loop)")
        while cost > stop_val and cycles < max_cycles:
            cost = self._reduce_cost(rotoselect, indexes_to_modify)
            cycles += 1
            cost_history.append(cost)
            if len(cost_history) > 3 and has_stopped_improving(
                    cost_history[-3:], tol):
                break
        logger.info(f"{alg_name} finished with cost {cost}")
        return cost

    def _reduce_cost(self, change_1q_gate_kind=False,
                     indexes_to_modify: Optional[Tuple[int, int]] = None):
        """Per-gate coordinate descent with full cost evaluations
        (cost_minimiser.py:267-316)."""
        cost = 1
        var_range = self.variational_circuit_range()
        if indexes_to_modify is None:
            indexes_to_modify = var_range
        else:
            indexes_to_modify = (max(indexes_to_modify[0], var_range[0]),
                                 min(indexes_to_modify[1], var_range[1]))

        if self.rotosolve_fraction < 1.0 and not change_1q_gate_kind:
            idx_list = co.find_rotation_indices(
                self.full_circuit, list(range(*indexes_to_modify)))
            num = int(np.ceil(self.rotosolve_fraction * len(idx_list)))
            sample = sorted(random.sample(idx_list, num))
        else:
            sample = list(range(*indexes_to_modify))

        for index in sample:
            instr = self.full_circuit.data[index]
            if change_1q_gate_kind and instr.is_supported_1q_gate():
                cost = self.replace_with_best_1q_gate(index)
            elif instr.is_supported_1q_gate():
                angle, cost = self.find_best_angle(index, instr.base_label
                                                   if instr.label is None or
                                                   "#" not in instr.label
                                                   else instr.label)
                co.replace_1q_gate(self.full_circuit, index,
                                   instr.label or instr.name, angle)
                self.compiler._invalidate_current()
            else:
                continue
        return cost

    def replace_with_best_1q_gate(self, gate_index):
        """cost_minimiser.py:318-342."""
        co.replace_1q_gate(self.full_circuit, gate_index, "rx", 0)
        self.compiler._invalidate_current()
        cost_identity = self.cost_finder()
        best_name, best_angle, best_cost = None, None, 1
        for gate_name in ("rx", "ry", "rz"):
            angle, cost = self.find_best_angle(gate_index, gate_name,
                                               cost_identity)
            if cost < best_cost:
                best_name, best_angle, best_cost = gate_name, angle, cost
        co.replace_1q_gate(self.full_circuit, gate_index, best_name, best_angle)
        self.compiler._invalidate_current()
        return best_cost

    def find_best_angle(self, gate_index, gate_name, cost_for_identity=None):
        """3-point sinusoidal probe (cost_minimiser.py:344-368)."""
        original = self.full_circuit.data[gate_index]
        costs = []
        angles_to_run = [0, np.pi / 2, -np.pi / 2]
        if cost_for_identity is not None:
            costs.append(cost_for_identity)
            angles_to_run.remove(0)
        for theta in angles_to_run:
            co.replace_1q_gate(self.full_circuit, gate_index, gate_name, theta)
            self.compiler._invalidate_current()
            costs.append(self.cost_finder())
        theta_min, cost_min = minimum_of_sinusoidal(*costs)
        self.full_circuit.data[gate_index] = original
        self.compiler._invalidate_current()
        return theta_min, cost_min

    # ----------------------------------------------------- generic optimisers
    def _find_cost_with_angles(self, angles, grad=None):
        co.update_angles_in_circuit(self.full_circuit, angles,
                                    self.variational_circuit_range())
        self.compiler._invalidate_current()
        if grad is not None and np.size(grad) > 0:
            self._update_gradient_of_circuit(grad)
        return self.cost_finder()

    def _scipy_minimize(self, method, tol, alg_kwargs):
        initial = co.find_angles_in_circuit(self.full_circuit,
                                            self.variational_circuit_range())
        if len(initial) == 0:
            return self.cost_finder()
        result = minimize(fun=self._find_cost_with_angles, method=method,
                          x0=initial, tol=tol, **alg_kwargs)
        co.update_angles_in_circuit(self.full_circuit, result["x"],
                                    self.variational_circuit_range())
        self.compiler._invalidate_current()
        return result["fun"]

    def _nlopt_minimize(self, algorithm_identifier, stop_val, tol):
        """cost_minimiser.py:108-142. When the nlopt package is absent the
        reference raises; here string identifiers naming a bounded
        derivative-free local algorithm ("LN_BOBYQA", or None) run on the
        native optim.bobyqa implementation instead — a documented deviation,
        logged, never a silent scipy substitution. Other identifiers raise
        exactly like the reference."""
        try:
            import nlopt
        except ModuleNotFoundError:
            if algorithm_identifier in (None, "LN_BOBYQA", "bobyqa"):
                logger.info("nlopt not installed: running the native BOBYQA "
                            "implementation (optim.bobyqa) for "
                            f"identifier={algorithm_identifier!r}")
                kw = {"rhoend": max(tol, 1e-10)}
                if np.isfinite(stop_val):
                    kw["stopval"] = stop_val
                return self._pybobyqa_minimize(kw)
            logger.error("NLOPT not installed and identifier "
                         f"{algorithm_identifier!r} has no native equivalent")
            raise
        initial = co.find_angles_in_circuit(self.full_circuit,
                                            self.variational_circuit_range())
        if len(initial) == 0:
            return self.cost_finder()
        opt = nlopt.opt(algorithm_identifier, len(initial))
        opt.set_upper_bounds([np.pi] * len(initial))
        opt.set_lower_bounds([-np.pi] * len(initial))
        opt.set_stopval(stop_val)
        opt.set_ftol_rel(tol)
        opt.set_xtol_abs(1e-10)
        opt.set_min_objective(self._find_cost_with_angles)
        final = opt.optimize(initial)
        co.update_angles_in_circuit(self.full_circuit, final,
                                    self.variational_circuit_range())
        self.compiler._invalidate_current()
        return opt.last_optimum_value()

    def _pybobyqa_minimize(self, alg_kwargs):
        """cost_minimiser.py:160-193: BOBYQA over all variational angles
        with [-pi, pi] bounds, objfun_has_noise, and restore-on-exception.
        Uses the pybobyqa package when installed, otherwise the native
        from-scratch implementation (optim.bobyqa) — the same algorithm, so
        perform_final_minimisation and the use_roto_algos=False paths run a
        REAL trust-region BOBYQA either way (no scipy substitution)."""
        initial = co.find_angles_in_circuit(self.full_circuit,
                                            self.variational_circuit_range())
        if len(initial) == 0:
            return self.cost_finder()
        alg_kwargs = dict(alg_kwargs)
        try:
            import pybobyqa
            solve = pybobyqa.solve
            alg_kwargs.pop("stopval", None)  # native-impl extension only
        except ModuleNotFoundError:
            logger.info("pybobyqa not installed: using the native BOBYQA "
                        "implementation (optim.bobyqa)")
            from . import bobyqa
            solve = bobyqa.solve
        bounds = ([-np.pi] * len(initial), [np.pi] * len(initial))
        try:
            result = solve(self._find_cost_with_angles, initial,
                           bounds=bounds, objfun_has_noise=True,
                           print_progress=False, do_logging=False,
                           **alg_kwargs)
            co.update_angles_in_circuit(self.full_circuit, result.x,
                                        self.variational_circuit_range())
            self.compiler._invalidate_current()
            return result.f
        except Exception as e:  # restore-and-report (cost_minimiser.py:188-193)
            logger.error(f"BOBYQA failed with exception: {e}")
            co.update_angles_in_circuit(self.full_circuit, initial,
                                        self.variational_circuit_range())
            self.compiler._invalidate_current()
            return self.cost_finder()

    # --------------------------------------------------- local-minimum escape
    def try_escaping_periodic_local_minimum(self, gap_between_minima,
                                            first_minima_loc, penalty_amp=0.1):
        """Sinusoidal-penalty escape (cost_minimiser.py:197-248)."""
        initial_cost = self.cost_finder()
        initial_angles = co.find_angles_in_circuit(
            self.full_circuit, self.variational_circuit_range())
        num_attempts = 5
        stochastic_param = 1

        def cost_with_penalty(angles, grad=None):
            cost = self._find_cost_with_angles(angles, grad)
            penalty = penalty_amp * np.cos(
                np.pi + ((cost - first_minima_loc) * 2 * np.pi
                         * (1 / gap_between_minima) * stochastic_param))
            return cost + penalty

        actual_cost = initial_cost
        for i in range(num_attempts):
            res = minimize(cost_with_penalty, initial_angles, method="Nelder-Mead")
            co.update_angles_in_circuit(self.full_circuit, res.x,
                                        self.variational_circuit_range())
            self.compiler._invalidate_current()
            actual_cost = self.cost_finder()
            logging.debug(f"{i}th attempt to escape minima: initial cost = "
                          f"{initial_cost}, final cost with penalty = {res.fun}, "
                          f"actual final cost = {actual_cost}")
            stochastic_param = np.random.random() * 10
            if actual_cost < initial_cost:
                break
        return actual_cost

    def _update_gradient_of_circuit(self, grad, method="parameter_shift"):
        """Parameter-shift gradient (cost_minimiser.py:370-418)."""
        angles = co.find_angles_in_circuit(self.full_circuit)
        angle_index = 0
        for gate_index in range(*self.variational_circuit_range()):
            instr = self.full_circuit.data[gate_index]
            if not instr.is_supported_1q_gate():
                continue
            label = instr.label or instr.name
            current = angles[angle_index]
            if method == "parameter_shift":
                r = 0.5
                shift = np.pi / (4 * r)
                co.replace_1q_gate(self.full_circuit, gate_index, label,
                                   current + shift)
                self.compiler._invalidate_current()
                vp = self.cost_finder()
                co.replace_1q_gate(self.full_circuit, gate_index, label,
                                   current - shift)
                self.compiler._invalidate_current()
                vm = self.cost_finder()
                grad[angle_index] = r * (vp - vm)
            else:
                vals = []
                for theta in (0, np.pi / 2, -np.pi / 2):
                    co.replace_1q_gate(self.full_circuit, gate_index, label, theta)
                    self.compiler._invalidate_current()
                    vals.append(self.cost_finder())
                grad[angle_index] = derivative_of_sinusoidal(current, *vals)
            co.replace_1q_gate(self.full_circuit, gate_index, label, current)
            self.compiler._invalidate_current()
            angle_index += 1
