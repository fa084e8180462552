"""AdaptCompiler: the ADAPT-AQC adaptive structure-learning loop.

API + semantics mirror of /root/reference/adaptaqc/compilers/adapt/
adapt_compiler.py: grow the ansatz one two-qubit block at a time, choosing the
qubit pair with one of six heuristics (ISL entanglement / expectation / basic /
random / general_gradient / brickwall), optimise the new block with
Rotoselect/Rotosolve, periodically re-optimise a trailing window, absorb
frozen layers into the cached MPS prefix, and stop on the reference's
termination criteria.

Device-side differences (behaviour-preserving):
 - pair scoring is batched on device (all 2-site RDMs / all pair gradients in
   one call) instead of a Python loop per pair;
 - Rotosolve/Rotoselect run as O(G) on-device sweeps (optim/sweeps.py);
 - "absorb into set_matrix_product_state" becomes advancing the cached
   on-device MPS prefix state (same bookkeeping, adapt_compiler.py:1097-1145).
"""

from __future__ import annotations

import logging
import os
import pickle
import timeit
from pathlib import Path

import numpy as np

from ..backends.backend import AQCBackend, SVBackend
from ..circuits import operations as co
from ..circuits import qasm
from ..circuits.circuit import Circuit
from ..circuits.peephole import remove_unnecessary_gates_from_circuit
from ..circuits.tape import compile_tape
from ..utils import ansatzes as ans
from ..utils import constants as vconstants
from ..utils import gradients as gr
from ..utils.constants import CMAP_FULL, generate_coupling_map
from ..utils.entanglement_measures import (EM_TOMOGRAPHY_CONCURRENCE,
                                           measure_from_rdm)
from ..optim.sinusoidal import has_stopped_improving
from .adapt_config import AdaptConfig
from .adapt_result import AdaptResult
from .approximate_compiler import (ApproximateCompiler,
                                   _wall_deadline_passed,
                                   calculate_overlap_between_circuits)

logger = logging.getLogger(__name__)


def _tape_has_2q(tape):
    """True where a tape entry is a 2-qubit gate (CX/CZ/SWAP/CXR)."""
    from ..circuits import gates as G
    kinds = np.asarray(tape.kinds)
    return ((kinds == G.CX) | (kinds == G.CZ) | (kinds == G.SWAP)
            | (kinds >= G.N_KINDS))


class AdaptCompiler(ApproximateCompiler):
    """Structure-learning compiler: incrementally builds a circuit with the
    same action on |0> as the target (adapt_compiler.py:48-53)."""

    def __init__(self, target, entanglement_measure=EM_TOMOGRAPHY_CONCURRENCE,
                 backend: AQCBackend = None, execute_kwargs=None,
                 coupling_map=None, adapt_config: AdaptConfig = None,
                 general_initial_state=False, custom_layer_2q_gate=None,
                 save_circuit_history=False, starting_circuit=None,
                 use_roto_algos=True, use_rotoselect=True,
                 use_advanced_transpilation=False, rotosolve_fraction=1.0,
                 perform_final_minimisation=False, optimise_local_cost=False,
                 soften_global_cost=False, debug_log_full_ansatz=False,
                 initial_single_qubit_layer=False, profile_dir=None,
                 zigzag=None, start_variant=0, **_compat):
        backend = backend if backend is not None else SVBackend()
        super().__init__(target=target, initial_state=None, backend=backend,
                         execute_kwargs=execute_kwargs,
                         general_initial_state=general_initial_state,
                         starting_circuit=starting_circuit,
                         optimise_local_cost=optimise_local_cost,
                         soften_global_cost=soften_global_cost,
                         rotosolve_fraction=rotosolve_fraction,
                         zigzag=zigzag, start_variant=start_variant)

        self.save_circuit_history = save_circuit_history
        self.entanglement_measure_method = entanglement_measure
        self.adapt_config = adapt_config if adapt_config is not None else AdaptConfig()

        if coupling_map is None:
            coupling_map = generate_coupling_map(self.total_num_qubits,
                                                 CMAP_FULL, False, False)

        # custom layer gates may have interdependent gates — don't clean up
        self.remove_unnecessary_gates_during_adapt = custom_layer_2q_gate is None
        self.use_roto_algos = use_roto_algos
        self.use_rotoselect = use_rotoselect
        self.use_advanced_transpilation = use_advanced_transpilation
        if not self.use_rotoselect and (
                custom_layer_2q_gate is None
                or co.are_circuits_identical(custom_layer_2q_gate,
                                             ans.thinly_dressed_cnot())
                or co.are_circuits_identical(custom_layer_2q_gate,
                                             ans.identity_resolvable())):
            logger.warning("Rotoselect is necessary for convergence of chosen ansatz")
        self.perform_final_minimisation = perform_final_minimisation
        self.layer_2q_gate = self.construct_layer_2q_gate(custom_layer_2q_gate)

        # avoid re-picking the same (unordered) pair repeatedly
        self.coupling_map = co.remove_permutations_from_coupling_map(coupling_map)
        self.coupling_map = [
            (q1, q2) for (q1, q2) in self.coupling_map
            if q1 in self.qubit_subset_to_compile
            and q2 in self.qubit_subset_to_compile]
        self.qubit_pair_history = []
        self.bad_qubit_pairs = []
        self.pair_selection_method_history = []
        self.entanglement_measures_history = []
        self.e_val_history = []
        self.general_gradient_history = []
        self.time_taken = None
        self.debug_log_full_ansatz = debug_log_full_ansatz
        self.initial_single_qubit_layer = initial_single_qubit_layer
        # tracing/profiling (SURVEY section 5): per-phase wall-clock totals,
        # and an optional jax.profiler trace of the whole compile
        self.profile_dir = profile_dir
        self.phase_timings = {"pair_selection": 0.0, "layer_optimisation": 0.0,
                              "window_rotosolve": 0.0, "absorption": 0.0,
                              "global_polish": 0.0}

        if self.is_mps_backend:
            # gates absorbed into the MPS prefix still need to appear in the
            # returned solution (adapt_compiler.py:196-199)
            self.layers_saved_to_mps = Circuit(self.full_circuit.num_qubits)
        self.layers_as_gates = []

        self.resume_from_layer = None
        self.prev_checkpoint_time_taken = None
        self._advance_hint = None
        self._absorption_bias = 0.0
        self._layers_since_verify = 0

        if self.adapt_config.method == "general_gradient":
            if not self.is_mps_backend:
                raise ValueError("general_gradient method is only implemented "
                                 "for the MPS backend")
            self.generators, self.degeneracies = gr.get_generators_and_degeneracies(
                self.layer_2q_gate, use_rotoselect, inverse=True)
            self.inverse_zero_ansatz = gr.zero_ansatz_inverse(self.layer_2q_gate)
            self._gradient_ops = gr.prepare_gradient_ops(
                self.inverse_zero_ansatz, self.generators)

        if self.soften_global_cost and self.optimise_local_cost:
            raise ValueError("soften_global_cost must be False when optimising "
                             "local cost")

        # construction knobs captured for compile_in_parts' per-part clones
        # (starting_circuit deliberately excluded: the carried ladder
        # solution rides through compile(initial_ansatz=...) instead;
        # profile_dir excluded to avoid nested profiler traces; backend
        # excluded so the checkpoint pickle codec — which sanitises
        # self.backend by name — stays the only live reference)
        self._ctor_kwargs = dict(
            entanglement_measure=entanglement_measure,
            execute_kwargs=execute_kwargs, coupling_map=coupling_map,
            adapt_config=adapt_config,
            general_initial_state=general_initial_state,
            custom_layer_2q_gate=custom_layer_2q_gate,
            save_circuit_history=save_circuit_history,
            use_roto_algos=use_roto_algos, use_rotoselect=use_rotoselect,
            use_advanced_transpilation=use_advanced_transpilation,
            rotosolve_fraction=rotosolve_fraction,
            perform_final_minimisation=perform_final_minimisation,
            optimise_local_cost=optimise_local_cost,
            soften_global_cost=soften_global_cost,
            debug_log_full_ansatz=debug_log_full_ansatz,
            initial_single_qubit_layer=initial_single_qubit_layer,
            zigzag=zigzag, start_variant=start_variant)

    def _clone_with_target(self, target, backend=None, starting_circuit=None):
        """Fresh AdaptCompiler for one compile_in_parts ladder part: same
        construction knobs, new target (gate circuit or engine MPS)."""
        return AdaptCompiler(target, backend=backend or self.backend,
                             starting_circuit=starting_circuit,
                             profile_dir=None, **self._ctor_kwargs)

    def compile_with_chi_schedule(self, chis=(32, 64, 128),
                                  initial_ansatz=None):
        """Escalating working-precision compile.

        The reference's Aer engine defaults ``max_chi`` to None — unbounded
        (aer_mps_backend.py:27-42 passes
        matrix_product_state_max_bond_dimension=max_chi, default None), so
        its in-loop cost is exact out of the box; static device shapes force a
        chi cap, and a binding cap
        makes the cost surrogate inexact mid-trajectory (the partially-built
        ansatz entangles above it — measured as an n-proportional plateau on
        the 50q fig5 workload, docs/design_notes.md "plateau anatomy").

        The static-shape answer: compile at ``chis[0]``, and while the
        verified sufficient-cost stop has not fired, re-compile warm-started
        from the previous stage's solution at each higher chi. Cheap stages
        do the bulk of the layer construction at small-chi sweep cost; the
        final stage only has to descend the (now small) surrogate error.
        Each stage pays one XLA recompile of the sweep programs for its new
        static shapes (persistently cached across runs).

        Returns the last stage's AdaptResult with ``cost_evaluations`` and
        ``time_taken`` aggregated across stages (including the between-stage
        ``_overlap_at_chi`` verification walls), an ``independent_overlap``
        always recorded for the returned solution, and a ``chi_schedule``
        attribute of per-stage ``(chi, overlap)`` pairs.
        """
        import time as _time
        from ..backends import mps_core
        from ..backends.backend import MPSBackend
        if not isinstance(self.backend, MPSBackend):
            raise ValueError("compile_with_chi_schedule requires an "
                             "MPSBackend (chi is its working precision)")
        if not chis:
            raise ValueError("chis must be a non-empty ascending sequence")
        sufficient = self.adapt_config.sufficient_cost
        carried = initial_ansatz
        stages, total_evals, total_time, result = [], 0, 0.0, None
        independent = None
        for i, chi in enumerate(chis):
            if i == 0 and chi == self.backend.max_chi:
                stage_compiler = self
            else:
                backend = MPSBackend(
                    self.backend.truncation_threshold, int(chi),
                    self.backend.mps_log_data, mesh=self.backend.mesh)
                # an engine-MPS target is pinned to its padded chi by
                # MPSBackend.initial_state (backend.py "cached MPS chi
                # mismatch"); re-gauge it to this stage's working chi the
                # same way _overlap_at_chi re-simulates at an arbitrary chi
                stage_target = self.target
                if isinstance(stage_target, mps_core.MPS):
                    stage_target = mps_core.regauge(
                        stage_target, backend.chi_for(stage_target.n))
                # the user's starting circuit only matters while there is no
                # carried ansatz (stage 1 without a warm start)
                stage_compiler = self._clone_with_target(
                    stage_target, backend=backend,
                    starting_circuit=(self.starting_circuit
                                      if carried is None else None))
            result = stage_compiler.compile(initial_ansatz=carried)
            total_evals += result.cost_evaluations
            total_time += result.time_taken
            stages.append((int(chi), result.overlap))
            logger.info("chi-schedule stage %d/%d (chi=%d): overlap %.6f",
                        i + 1, len(chis), chi, result.overlap)
            carried = result.circuit
            independent = None
            if _wall_deadline_passed() and i < len(chis) - 1:
                logger.warning("ADAPTAQC_WALL_DEADLINE reached; not "
                               "escalating past chi=%d", chi)
                break
            if 1.0 - result.overlap <= sufficient and i < len(chis) - 1:
                # a gate-circuit target is itself SIMULATED at the stage's
                # working chi, so a stage at a binding cap can "converge"
                # against a truncated target; only stop escalating once the
                # solution clears the threshold against the ORIGINAL target
                # at the schedule's final chi
                t0 = _time.perf_counter()
                independent = self._overlap_at_chi(result.circuit, chis[-1])
                total_time += _time.perf_counter() - t0
                result.independent_overlap = independent
                if 1.0 - independent <= sufficient:
                    logger.info("chi-schedule: stage %d solution clears the "
                                "threshold at chi=%d (overlap %.6f); "
                                "stopping early", i + 1, chis[-1], independent)
                    break
        if independent is None:
            # the returned solution always carries an original-target
            # verification at the schedule's final chi (VERDICT r3 weak 6:
            # records built on this API must not flatter wall-clock or skip
            # the independent check on the last stage)
            t0 = _time.perf_counter()
            independent = self._overlap_at_chi(result.circuit, chis[-1])
            total_time += _time.perf_counter() - t0
            result.independent_overlap = independent
        result.cost_evaluations = total_evals
        result.time_taken = total_time
        result.chi_schedule = stages
        return result

    def _overlap_at_chi(self, qc, chi: int) -> float:
        """|<target|qc|0>|^2 with both sides re-simulated from the ORIGINAL
        target at bond dimension ``chi``, normalised by both norms —
        independent of every working-chi artifact (for gate-circuit targets
        the in-loop target payload is itself simulated at the working chi,
        so ``result.overlap`` at a binding cap measures fidelity to a
        truncated target)."""
        import jax.numpy as jnp
        from ..backends import mps_core
        from ..ops import cplx
        n = qc.num_qubits
        chi = int(min(chi, 2 ** ((n + 1) // 2)))
        thr = self.backend.truncation_threshold
        if mps_core.check_mps(self.target):
            if isinstance(self.target, mps_core.MPS):
                target = (mps_core.pad_chi(self.target, chi)
                          if chi > self.target.chi else self.target)
            else:
                target = mps_core.from_qiskit_mps(self.target, chi)
        else:
            tt = compile_tape(co.make_quantum_only_circuit(self.target))
            target = mps_core.apply_tape(
                mps_core.zero_mps(n, chi), jnp.asarray(tt.kinds),
                jnp.asarray(tt.q0), jnp.asarray(tt.q1),
                jnp.asarray(tt.angles), thr)
        st = compile_tape(co.make_quantum_only_circuit(qc))
        state = mps_core.apply_tape(
            mps_core.zero_mps(n, chi), jnp.asarray(st.kinds),
            jnp.asarray(st.q0), jnp.asarray(st.q1),
            jnp.asarray(st.angles), thr)
        nrm2 = float(mps_core.mps_dot(state, state).re)
        tnrm2 = float(mps_core.mps_dot(target, target).re)
        return float(mps_core.mps_dot(target, state).abs2()
                     / max(nrm2 * tnrm2, 1e-30))

    # ------------------------------------------------------------ layer gate
    def construct_layer_2q_gate(self, custom_layer_2q_gate) -> Circuit:
        """Default: thinly-dressed CNOT (adapt_compiler.py:224-239)."""
        if custom_layer_2q_gate is None:
            qc = Circuit(2)
            if self.general_initial_state:
                co.add_dressed_cnot(qc, 0, 1, True)
                co.add_dressed_cnot(qc, 0, 1, True, v1=False, v2=False)
            else:
                co.add_dressed_cnot(qc, 0, 1, True)
            return qc
        qc = custom_layer_2q_gate.copy()
        for instr in qc.data:
            if instr.label is None and instr.name in co.SUPPORTED_1Q_GATES:
                instr.label = instr.name
        return qc

    def get_layer_2q_gate(self, layer_index) -> Circuit:
        qc = self.layer_2q_gate.copy()
        co.add_subscript_to_all_variables(qc, layer_index)
        return qc

    # -------------------------------------------------------------- compile
    def compile(self, initial_ansatz: Circuit = None,
                optimise_initial_ansatz=True, checkpoint_every=0,
                checkpoint_dir="checkpoint/", delete_prev_chkpt=False,
                freeze_prev_layers=False) -> AdaptResult:
        """Main adaptive loop (adapt_compiler.py:246-482)."""
        if self.profile_dir:
            import jax
            with jax.profiler.trace(self.profile_dir):
                return self._compile_impl(initial_ansatz,
                                          optimise_initial_ansatz,
                                          checkpoint_every, checkpoint_dir,
                                          delete_prev_chkpt,
                                          freeze_prev_layers)
        return self._compile_impl(initial_ansatz, optimise_initial_ansatz,
                                  checkpoint_every, checkpoint_dir,
                                  delete_prev_chkpt, freeze_prev_layers)

    def _compile_impl(self, initial_ansatz, optimise_initial_ansatz,
                      checkpoint_every, checkpoint_dir, delete_prev_chkpt,
                      freeze_prev_layers) -> AdaptResult:
        start_time = timeit.default_timer()
        if self.resume_from_layer is None:
            self.time_taken = 0
            start_point = 0
            logger.info("ADAPT-AQC started")
            logger.debug(f"ADAPT-AQC coupling map {self.coupling_map}")
            self.cost_evaluation_counter = 0
            self.global_cost, self.local_cost = None, None
            self.cnot_depth = None
            self.global_cost_history = []
            if self.optimise_local_cost:
                self.local_cost_history = []
            self.circuit_history = []
            self.cnot_depth_history = []
            self.g_range = self.variational_circuit_range
            self.original_lhs_gate_count = self.lhs_gate_count

            if freeze_prev_layers:
                logger.warning("freeze_prev_layers only applies when resuming "
                               "from a checkpoint")
            self.initial_ansatz_already_successful = False
            if initial_ansatz is not None:
                self._add_initial_ansatz(initial_ansatz, optimise_initial_ansatz)
        else:
            start_point = self.resume_from_layer
            self.time_taken = self.prev_checkpoint_time_taken
            logger.info(f"ADAPT-AQC resuming from layer: {start_point}")
            if initial_ansatz is not None:
                logger.warning("An initial ansatz will be ignored when resuming "
                               "recompilation from a checkpoint")
            if freeze_prev_layers:
                if self.is_mps_backend:
                    num_gates = (len(self.full_circuit) - self.rhs_gate_count
                                 - self.lhs_gate_count)
                    gates_absorbed = self._absorb_n_gates_into_mps(num_gates)
                    co.add_to_circuit(self.layers_saved_to_mps, gates_absorbed)
                else:
                    self.lhs_gate_count = self.variational_circuit_range()[1]

        if checkpoint_every > 0:
            Path(checkpoint_dir).mkdir(parents=True, exist_ok=True)

        for layer_count in range(start_point, self.adapt_config.max_layers):
            if self.initial_ansatz_already_successful:
                break
            logger.info(f"global cost entering layer: {self.global_cost}")
            if self.optimise_local_cost:
                self.local_cost = self._add_layer(layer_count)
                self.global_cost = self.backend.evaluate_global_cost(self)
                self.local_cost_history.append(self.local_cost)
            else:
                self.global_cost = self._add_layer(layer_count)
            self.global_cost_history.append(self.global_cost)
            self.record_cnot_depth()
            self._log_full_ansatz()

            # keeping the gate count constant is required for MPS caching
            if (self.remove_unnecessary_gates_during_adapt
                    and not self.is_mps_backend):
                remove_unnecessary_gates_from_circuit(
                    self.full_circuit, False, False, gate_range=self.g_range())
                self._invalidate_current()

            num_2q_gates, num_1q_gates = co.find_num_gates(
                circuit=self.ref_circuit_as_gates if self.is_mps_backend
                else self.full_circuit,
                gate_range=self.g_range(self.ref_circuit_as_gates)
                if self.is_mps_backend else self.g_range())

            if self.save_circuit_history:
                snapshot = (self.ref_circuit_as_gates if self.is_mps_backend
                            else self.full_circuit)
                snapshot = co.make_quantum_only_circuit(snapshot)
                if snapshot.data and snapshot.data[0].name in ("set_mps",
                                                               "set_statevector"):
                    snapshot = co.extract_inner_circuit(
                        snapshot, (1, len(snapshot.data)))
                self.circuit_history.append(qasm.dumps(snapshot))

            # cinl may be float (callers pass math.inf to disable the check)
            cinl = self.adapt_config.cost_improvement_num_layers
            cit = self.adapt_config.cost_improvement_tol
            if len(self.global_cost_history) >= cinl and has_stopped_improving(
                    self.global_cost_history[-int(cinl):], cit):
                logger.warning("cost plateaued across the improvement window; stopping")
                self.compiling_finished = True
                break
            if self._should_verify_threshold():
                if self._sufficient_cost_verified():
                    logger.info("sufficient-cost threshold reached; "
                                "ansatz accepted")
                    self.compiling_finished = True
                    break
            elif num_2q_gates >= self.adapt_config.max_2q_gates:
                logger.warning("2q-gate budget exhausted; one final Rotosolve pass")
                self.minimizer.minimize_cost(
                    algorithm_kind=vconstants.ALG_ROTOSOLVE, max_cycles=10,
                    tol=1e-5, stop_val=self.adapt_config.sufficient_cost)
                self.compiling_finished = True
                break

            if _wall_deadline_passed():
                logger.warning("ADAPTAQC_WALL_DEADLINE reached; stopping "
                               "with the best-so-far ansatz")
                self.compiling_finished = True
                break

            if checkpoint_every > 0 and layer_count % checkpoint_every == 0:
                self.checkpoint(checkpoint_every, checkpoint_dir,
                                delete_prev_chkpt, layer_count, start_time)

        if self.perform_final_minimisation:
            self.minimizer.minimize_cost(
                algorithm_kind=vconstants.ALG_PYBOBYQA,
                alg_kwargs={"seek_global_minimum": False})

        if self.is_mps_backend:
            # swap in the pure-gate representation for final cleanup
            self.full_circuit = self.ref_circuit_as_gates
            self.lhs_gate_count = 1  # the set_mps target instruction
            self._invalidate_prefix()
        else:
            self.lhs_gate_count = self.original_lhs_gate_count

        remove_unnecessary_gates_from_circuit(self.full_circuit, True, True,
                                              gate_range=self.g_range())
        self._invalidate_current()

        # final cost = 1 - |<solution|target>|^2, softening disabled
        if self.soften_global_cost:
            self.soften_global_cost = False
            final_global_cost = self.backend.evaluate_global_cost(self)
            self.soften_global_cost = True
        elif self._verification_applies():
            # report the true cost: working-chi re-simulation both
            # over-reads (absorbed prefix) and under-reads (good states it
            # cannot represent); the chi-doubled embedding is exact
            final_global_cost = self._true_cost_of_gate_circuit(
                self.full_circuit)
        else:
            final_global_cost = self.backend.evaluate_global_cost(self)
        logger.info(f"Final global cost: {final_global_cost}")
        self.global_cost_history.append(final_global_cost)
        mps_truncated_weight = None
        if self.is_mps_backend:
            state = self.backend.state_of(self)
            mps_truncated_weight = self.backend.truncated_weight(state)
            # discriminate real truncation from accumulated per-apply
            # rounding residue (~eps per 2q apply, much larger under f32)
            noise_floor = 1e4 * float(np.finfo(
                np.asarray(state.lam).dtype).eps)
            if mps_truncated_weight > noise_floor:
                logger.warning(
                    "MPS truncation discarded relative Schmidt weight "
                    f"{mps_truncated_weight:.3e} during this compile — "
                    f"max_chi={self.backend.max_chi} or the truncation "
                    "threshold is binding; overlaps may be inaccurate. "
                    "Raise max_chi to make the simulation exact.")
        if checkpoint_every > 0:
            self.checkpoint(checkpoint_every, checkpoint_dir, delete_prev_chkpt,
                            len(self.qubit_pair_history) - 1, start_time)
        compiled_circuit = self.get_compiled_circuit()

        num_2q_gates, num_1q_gates = co.find_num_gates(compiled_circuit)
        final_cnot_depth = compiled_circuit.multi_qubit_gate_depth()
        logger.info(f"Final CNOT depth: {final_cnot_depth}")
        self.cnot_depth_history.append(final_cnot_depth)

        exact_overlap = "Not computable without SV backend"
        if self.is_statevector_backend:
            exact_overlap = calculate_overlap_between_circuits(
                self.circuit_to_compile,
                co.make_quantum_only_circuit(compiled_circuit))

        result = AdaptResult(
            circuit=compiled_circuit,
            overlap=1 - final_global_cost,
            exact_overlap=exact_overlap,
            num_1q_gates=num_1q_gates,
            num_2q_gates=num_2q_gates,
            cnot_depth_history=self.cnot_depth_history,
            global_cost_history=self.global_cost_history,
            local_cost_history=(self.local_cost_history
                                if self.optimise_local_cost else None),
            circuit_history=self.circuit_history,
            entanglement_measures_history=self.entanglement_measures_history,
            e_val_history=self.e_val_history,
            qubit_pair_history=self.qubit_pair_history,
            method_history=self.pair_selection_method_history,
            time_taken=self.time_taken + (timeit.default_timer() - start_time),
            cost_evaluations=self.cost_evaluation_counter,
            coupling_map=self.coupling_map,
            circuit_qasm=qasm.dumps(co.make_quantum_only_circuit(
                compiled_circuit)),
        )
        # observability extra over the reference: how much Schmidt weight the
        # MPS engine dropped (None for non-MPS backends; 0.0 = exact)
        result.mps_truncated_weight = mps_truncated_weight
        result.phase_timings = dict(self.phase_timings)
        logger.info("ADAPT-AQC completed")
        return result

    # --------------------------------------------------------- MPS reference
    @property
    def ref_circuit_as_gates(self) -> Circuit:
        """Pure-gate view of the full circuit: absorbed layers re-expanded
        (adapt_compiler.py:708-715). Only meaningful for the MPS backend."""
        if not self.is_mps_backend:
            return self.full_circuit
        qc = Circuit(self.full_circuit.num_qubits, self.full_circuit.num_clbits)
        # data[0] is the set_mps TARGET instruction; keep it as the lhs marker
        qc.data.append(self._target_instruction.copy())
        co.add_to_circuit(qc, self.layers_saved_to_mps)
        rest = co.extract_inner_circuit(self.full_circuit,
                                        (1, len(self.full_circuit.data)))
        co.add_to_circuit(qc, rest)
        return qc

    @property
    def _target_instruction(self):
        if not hasattr(self, "_orig_target_instr"):
            self._orig_target_instr = self.circuit_to_compile.data[0].copy()
        return self._orig_target_instr

    # ------------------------------------------------------------ checkpoint
    def checkpoint(self, checkpoint_every, checkpoint_dir, delete_prev_chkpt,
                   layer_count, start_time):
        """Pickle the whole compiler (adapt_compiler.py:484-506)."""
        self.resume_from_layer = layer_count + 1
        current = timeit.default_timer() - start_time
        self.prev_checkpoint_time_taken = self.time_taken + current
        file_name = f"{layer_count}.pkl"
        with open(os.path.join(checkpoint_dir, file_name), "wb") as f:
            pickle.dump(self, f)
        if delete_prev_chkpt:
            try:
                os.remove(os.path.join(
                    checkpoint_dir, f"{layer_count - checkpoint_every}.pkl"))
            except FileNotFoundError:
                pass

    def __getstate__(self):
        """Make the compiler picklable: device states -> numpy, drop caches."""
        from ..io.checkpoint import encode_compiler_state
        return encode_compiler_state(self)

    def __setstate__(self, state):
        from ..io.checkpoint import decode_compiler_state
        decode_compiler_state(self, state)

    # -------------------------------------------------------- initial ansatz
    def _add_initial_ansatz(self, initial_ansatz, optimise_initial_ansatz):
        """adapt_compiler.py:536-583."""
        initial_ansatz = initial_ansatz.copy()
        for instr in initial_ansatz.data:
            if instr.label is None and instr.name in co.SUPPORTED_1Q_GATES:
                instr.label = instr.name
        co.add_to_circuit(self.full_circuit,
                          co.circuit_by_inverting_circuit(initial_ansatz),
                          self.variational_circuit_range()[1])
        self._invalidate_current()
        if optimise_initial_ansatz:
            if self.use_roto_algos:
                cost = self.minimizer.minimize_cost(
                    algorithm_kind=vconstants.ALG_ROTOSOLVE, tol=1e-3,
                    stop_val=0 if self.optimise_local_cost
                    else self.adapt_config.sufficient_cost,
                    indexes_to_modify=self.variational_circuit_range())
            else:
                cost = self.minimizer.minimize_cost(
                    algorithm_kind=vconstants.ALG_PYBOBYQA,
                    alg_kwargs={"seek_global_minimum": True})
        else:
            cost = self.evaluate_cost()

        self.global_cost = (self.backend.evaluate_global_cost(self)
                            if self.optimise_local_cost else cost)
        self.cnot_depth = initial_ansatz.multi_qubit_gate_depth()

        if self.global_cost < self.adapt_config.sufficient_cost:
            self.initial_ansatz_already_successful = True
            logger.debug("the provided initial ansatz alone already meets the "
                         "sufficient-cost threshold")

        if self.is_mps_backend:
            gates_absorbed = self._absorb_n_gates_into_mps(len(initial_ansatz.data))
            co.add_to_circuit(self.layers_saved_to_mps, gates_absorbed)
        else:
            self.lhs_gate_count = self.variational_circuit_range()[1]

    # ------------------------------------------------------------- add layer
    def _add_layer(self, index):
        """adapt_compiler.py:585-689."""
        ansatz_start_index = self.variational_circuit_range()[0]
        if self.initial_single_qubit_layer and index == 0:
            logger.debug("layer 0 is the initial single-qubit rotation layer")
            layer_indexes = self._add_rotation_to_all_qubits()
        else:
            layer_indexes = self._add_entangling_layer(index)

        stop_val = 0 if self.optimise_local_cost else \
            self.adapt_config.sufficient_cost

        if self.use_roto_algos:
            if self.use_rotoselect or (self.initial_single_qubit_layer
                                       and index == 0):
                alg = vconstants.ALG_ROTOSELECT
            else:
                alg = vconstants.ALG_ROTOSOLVE
            t0 = timeit.default_timer()
            cost = self.minimizer.minimize_cost(
                algorithm_kind=alg, tol=self.adapt_config.rotoselect_tol,
                stop_val=stop_val, indexes_to_modify=layer_indexes)
            self.phase_timings["layer_optimisation"] += \
                timeit.default_timer() - t0
            if (self.adapt_config.rotosolve_frequency != 0 and index > 0
                    and index % self.adapt_config.rotosolve_frequency == 0):
                # under the local cost the probe sweep is O(W^2) per cycle
                # (no O(G) environment trick for per-qubit costs): clamp the
                # window to local_window_layers — the periodic global polish
                # below covers the full max_layers_to_modify window instead
                window_cap = (self.adapt_config.local_window_layers
                              if self.optimise_local_cost else None)
                multi_indexes = self._calculate_multi_layer_optimisation_indices(
                    ansatz_start_index, max_layers=window_cap)
                if self.use_advanced_transpilation:
                    from ..circuits.peephole import advanced_circuit_transpilation
                    variational = co.extract_inner_circuit(
                        self.full_circuit, self.variational_circuit_range())
                    advanced_circuit_transpilation(variational,
                                                   self.coupling_map)
                    co.replace_inner_circuit(self.full_circuit, variational,
                                             self.variational_circuit_range())
                    self._invalidate_current()
                t0 = timeit.default_timer()
                cost = self.minimizer.minimize_cost(
                    algorithm_kind=vconstants.ALG_ROTOSOLVE,
                    tol=self.adapt_config.rotosolve_tol, stop_val=stop_val,
                    indexes_to_modify=multi_indexes)
                self.phase_timings["window_rotosolve"] += \
                    timeit.default_timer() - t0
            gpf = self.adapt_config.global_polish_frequency
            if (self.optimise_local_cost and gpf and index > 0
                    and index % gpf == 0
                    # only the device overlap sweep optimises the right
                    # objective under force_global; without it (SV/host
                    # paths) minimize_cost would fall through to the local
                    # probe loop and "polish" the wrong cost
                    and self.minimizer._can_fast_sweep(force_global=True)):
                # hybrid schedule (beyond-reference): the local cost gives
                # trainable per-layer signal at large n (the reference's own
                # barren-plateau argument, docs/running_options_explained.md
                # local_cost_function), while a periodic GLOBAL-cost
                # Rotosolve over the full window — the O(G) device sweep —
                # consolidates toward the actual overlap objective
                full_indexes = self._calculate_multi_layer_optimisation_indices(
                    ansatz_start_index)
                t0 = timeit.default_timer()
                self.minimizer.minimize_cost(
                    algorithm_kind=vconstants.ALG_ROTOSOLVE,
                    tol=self.adapt_config.rotosolve_tol,
                    stop_val=self.adapt_config.sufficient_cost,
                    indexes_to_modify=full_indexes, force_global=True)
                self.phase_timings["global_polish"] += \
                    timeit.default_timer() - t0
        else:
            cost = self.minimizer.minimize_cost(
                algorithm_kind=vconstants.ALG_PYBOBYQA,
                alg_kwargs={"seek_global_minimum": True})

        if self.is_mps_backend:
            t0 = timeit.default_timer()
            self.layers_as_gates.append(index)
            num_to_absorb = self._calculate_num_layers_to_absorb(index)
            if num_to_absorb > 0:
                includes_isql = (self.layers_as_gates[0] == 0
                                 and self.initial_single_qubit_layer)
                num_gates = self._get_num_gates_to_cache(
                    n=num_to_absorb, includes_isql=includes_isql)
                gates_absorbed = self._absorb_n_gates_into_mps(num_gates)
                co.add_to_circuit(self.layers_saved_to_mps, gates_absorbed)
                del self.layers_as_gates[:num_to_absorb]
            self.phase_timings["absorption"] += timeit.default_timer() - t0
        return cost

    def _calculate_num_layers_to_absorb(self, index):
        """adapt_compiler.py:691-706."""
        freq = self.adapt_config.rotosolve_frequency
        if freq == 0:
            # rotosolve disabled -> everything already finalised is absorbable
            lowest_index = index
        else:
            layers_since = index % freq
            layers_to_next = freq - layers_since
            next_rotosolve_layer = index + layers_to_next
            lowest_index = (next_rotosolve_layer
                            - self.adapt_config.max_layers_to_modify + 1)
        return len([i for i in self.layers_as_gates if i < lowest_index])

    def _calculate_multi_layer_optimisation_indices(self, ansatz_start_index,
                                                    max_layers=None):
        """adapt_compiler.py:717-741. `max_layers` overrides
        max_layers_to_modify (the local-cost window clamp)."""
        if max_layers is None:
            max_layers = self.adapt_config.max_layers_to_modify
        num_entangling = (max_layers
                          - int(self.initial_single_qubit_layer))
        num_isql_gates = (self.full_circuit.num_qubits
                          * int(self.initial_single_qubit_layer))
        start = max(ansatz_start_index,
                    self.variational_circuit_range()[1]
                    - len(self.layer_2q_gate.data) * num_entangling
                    - num_isql_gates)
        first_layer_end = ansatz_start_index + num_isql_gates
        if ansatz_start_index < start < first_layer_end:
            start = first_layer_end
        return (start, self.variational_circuit_range()[1])

    def _add_entangling_layer(self, index):
        """adapt_compiler.py:743-759."""
        logger.debug("scoring candidate qubit pairs")
        t0 = timeit.default_timer()
        control, target = self._find_appropriate_qubit_pair()
        self.phase_timings["pair_selection"] += timeit.default_timer() - t0
        logger.debug(f"selected pair {(control, target)}")
        insert_at = self.variational_circuit_range()[1]
        self._stash_advance_hint(insert_at)
        co.add_to_circuit(self.full_circuit, self.get_layer_2q_gate(index),
                          insert_at, qubit_subset=[control, target])
        self._invalidate_current()
        self.qubit_pair_history.append((control, target))
        return (self.variational_circuit_range()[1] - len(self.layer_2q_gate.data),
                self.variational_circuit_range()[1])

    # how close (in units of sufficient_cost) the in-loop estimate must be
    # before periodic true-cost verification starts, and how many layers
    # separate periodic checks
    _VERIFY_BAND = 3.0
    _VERIFY_EVERY = 20

    def _should_verify_threshold(self) -> bool:
        """When to run the (relatively expensive) true-cost verification.

        The chi-capped in-loop cost is a BIASED estimate of the true cost —
        optimistic through the absorbed prefix, pessimistic through the
        working-chi re-simulation of a good state (measured ~±4e-3 at 50q).
        Because the bias can have either sign, triggering only on the raw
        threshold is wrong in both directions: a compile can stop short, or
        grind on for hundreds of layers after the TRUE overlap crossed the
        target (observed: working estimate 0.9869 at the layer cap while
        the chi-doubled check read 0.9908). Verify when the in-loop cost
        clears threshold + measured bias, or periodically while it sits
        within _VERIFY_BAND x threshold."""
        if not self._verification_applies():
            return self.global_cost < self.adapt_config.sufficient_cost
        sufficient = self.adapt_config.sufficient_cost
        self._layers_since_verify += 1
        # rate-limit: when the in-loop estimate keeps improving against a
        # stalled true cost, the margin trigger would otherwise fire every
        # layer and each check re-simulates the whole ansatz at 2x chi
        if self._layers_since_verify < 5:
            return False
        if self.global_cost < sufficient - self._absorption_bias:
            return True
        return (self.global_cost < self._VERIFY_BAND * sufficient
                and self._layers_since_verify >= self._VERIFY_EVERY)

    def _verification_applies(self) -> bool:
        return (self.is_mps_backend and not self.optimise_local_cost
                and not self.soften_global_cost)

    def _sufficient_cost_verified(self) -> bool:
        """Accept the sufficient-cost stop only if the TRUE cost of what
        will be returned clears the threshold.

        "True" = the full ansatz WITH the end-of-compile gate cleanup
        applied (small-angle pruning alone moves the overlap ~1e-3 at 50q),
        re-simulated from the original target at DOUBLE the working bond
        dimension (exact zero-padding embedding) — the working-chi estimate
        both over-reads through the absorbed prefix and under-reads a good
        state it cannot represent. The reference needs none of this: Aer
        runs unbounded bond dimension, so its in-loop cost is the true
        cost. The signed estimate bias is remembered to schedule the next
        verification."""
        if not self._verification_applies():
            return True
        exact = self._true_cost_of_cleaned_circuit()
        self.cost_evaluation_counter += 1
        self._layers_since_verify = 0
        if exact < self.adapt_config.sufficient_cost:
            self.global_cost = exact
            return True
        self._absorption_bias = exact - self.global_cost
        logger.info(
            f"in-loop cost estimate {self.global_cost:.3e} vs true "
            f"(chi-doubled, cleaned) cost {exact:.3e} "
            f"(estimate bias {self._absorption_bias:+.1e}); continuing")
        return False

    def _true_cost_of_cleaned_circuit(self) -> float:
        """1 - |<0|cleaned ansatz . target>|^2 at 2x the working chi."""
        qc = self.ref_circuit_as_gates.copy()
        remove_unnecessary_gates_from_circuit(
            qc, True, True,
            gate_range=(1, len(qc.data) - self.rhs_gate_count))
        return self._true_cost_of_gate_circuit(qc)

    def _true_cost_of_gate_circuit(self, qc) -> float:
        """True cost of a pure-gate circuit whose data[0] is the target
        state-injection instruction, evaluated at double the working bond
        dimension the way a USER would measure the deliverable:
        |solution> = (gates)^dag |0> (identical gate sequence to simulating
        the returned circuit forward), overlapped with the target embedded
        exactly (zero padding) at the doubled chi. Evolving the target
        forward through the ansatz instead gives a different truncation
        path whose estimate sits ~1e-3 below this one at 50q — runs used
        to grind hundreds of layers past the point where the returned
        circuit already cleared the threshold."""
        import jax.numpy as jnp
        from ..backends import mps_core
        from ..ops import cplx
        n = qc.num_qubits
        chi = self.backend.chi_for(n)
        verify_chi = min(2 * chi, 2 ** ((n + 1) // 2))
        payload = qc.data[0].payload
        if qc.data[0].name == "set_statevector":
            target = mps_core.from_dense(payload, verify_chi)
        elif isinstance(payload, mps_core.MPS):
            target = mps_core.pad_chi(payload, verify_chi)
        else:
            target = mps_core.from_qiskit_mps(payload, verify_chi)
        rng = (1, len(qc.data))
        state = mps_core.zero_mps(n, verify_chi)
        if rng[1] > rng[0]:
            tape = compile_tape(qc, rng)
            state = mps_core.apply_tape_adjoint(
                state, jnp.asarray(tape.kinds), jnp.asarray(tape.q0),
                jnp.asarray(tape.q1), jnp.asarray(tape.angles),
                self.backend.truncation_threshold)
        # normalise by BOTH norms: at verify_chi >> the state's true
        # rank, f32 apply chains drift in SCALE (direction intact) —
        # without this the chi-doubled verification can read overlap > 1
        # or reject a converged state (seed-56 chi=64 run read 0.39 vs
        # true 0.99). The embedded target is normalised on import but
        # f32 conversion can leave <t|t> a few ulp off 1.
        nrm2 = float(mps_core.mps_dot(state, state).re)
        tnrm2 = float(mps_core.mps_dot(target, target).re)
        denom = max(nrm2 * tnrm2, 1e-30)
        return float(1.0 - mps_core.mps_dot(state, target).abs2() / denom)

    def _stash_advance_hint(self, insert_at):
        """Hand the optimiser the engine state of full_circuit.data[:insert_at]
        (everything before the about-to-be-inserted layer), derived from the
        cached full state by peeling the trailing 1q starting-circuit gates —
        so the per-layer Rotoselect's prefix advance costs ~n 1q adjoints
        instead of re-simulating the whole unabsorbed window (~200 bond SVDs
        at 50q with the reference-default schedule)."""
        self._advance_hint = None
        if self._current_cache is None:
            return
        if self.rhs_gate_count == 0:
            self._advance_hint = (insert_at, self._current_cache)
            return
        rhs_rng = (len(self.full_circuit.data) - self.rhs_gate_count,
                   len(self.full_circuit.data))
        if insert_at != rhs_rng[0]:
            return
        rhs_tape = compile_tape(self.full_circuit, rhs_rng)
        if np.any(_tape_has_2q(rhs_tape)):
            return
        self._advance_hint = (insert_at, self.backend.run_tape_adjoint(
            self._current_cache, rhs_tape))

    def _add_rotation_to_all_qubits(self):
        """initial_single_qubit_layer (adapt_compiler.py:761-773)."""
        n = self.full_circuit.num_qubits
        first_layer = Circuit(n)
        first_layer.ry(0, range(n))
        insert_at = self.variational_circuit_range()[1]
        self._stash_advance_hint(insert_at)
        co.add_to_circuit(self.full_circuit, first_layer, insert_at)
        self._invalidate_current()
        self._first_layer_increment_results_dict()
        return (self.variational_circuit_range()[1] - n,
                self.variational_circuit_range()[1])

    # --------------------------------------------------------- pair selection
    def _find_appropriate_qubit_pair(self):
        """Heuristic dispatch (adapt_compiler.py:775-830)."""
        method = self.adapt_config.method
        if method == "random":
            self.pair_selection_method_history.append("random")
            return self.coupling_map[np.random.randint(len(self.coupling_map))]
        if method == "basic":
            self.pair_selection_method_history.append("basic")
            priorities = self._get_all_qubit_pair_reuse_priorities(1)
            return self.coupling_map[int(np.argmax(priorities))]
        if method == "expectation":
            return self._find_best_expectation_qubit_pair()
        if method == "ISL":
            logger.debug("Computing entanglement of pairs")
            ems = self._get_all_qubit_pair_entanglement_measures()
            self.entanglement_measures_history.append(ems)
            return self._find_best_entanglement_qubit_pair(ems)
        if method == "general_gradient":
            logger.debug("Computing gradients of pairs")
            gradients = self._get_all_qubit_pair_gradients()
            self.general_gradient_history.append(gradients)
            self.pair_selection_method_history.append("general_gradient")
            return self._find_best_gradient_qubit_pair(gradients)
        if method == "brickwall":
            return self._next_brickwall_pair()
        raise ValueError(
            f"Invalid compiling method {method}. Method must be one of ISL, "
            "expectation, random, basic, general_gradient, brickwall")

    def _next_brickwall_pair(self):
        """adapt_compiler.py:803-825."""
        n = self.full_circuit.num_qubits
        if n < 2:
            raise ValueError("Cannot pick a pair if there are fewer than two qubits")
        if (len(self.qubit_pair_history) == 0 or n == 2
                or self.qubit_pair_history[-1][0] is None):
            return (0, 1)
        prev = self.qubit_pair_history[-1]
        nxt = (prev[0] + 2, prev[1] + 2)
        n_odd = n % 2
        if nxt == (n, n + 1):
            return (1 - n_odd, 2 - n_odd)
        if nxt == (n - 1, n):
            return (0 + n_odd, 1 + n_odd)
        return nxt

    def _find_best_gradient_qubit_pair(self, gradients):
        priorities = self._get_all_qubit_pair_reuse_priorities(
            self.adapt_config.reuse_exponent)
        combined = np.multiply(gradients, priorities)
        return self.coupling_map[int(np.argmax(combined))]

    def _get_all_qubit_pair_gradients(self):
        """Batched on-device pair-gradient scoring (adapt_compiler.py:839-856
        + gradients.py:23-124)."""
        psi = self._state_without_starting_circuit()
        gradients = gr.general_grad_of_pairs_device(
            psi, self.starting_circuit, self._gradient_ops,
            self.degeneracies, self.coupling_map, self.backend,
            self.full_circuit.num_qubits)
        logger.debug(f"per-pair gradient norms: {gradients}")
        return gradients

    def _state_without_starting_circuit(self):
        """Engine state of full_circuit minus the trailing starting-circuit
        inverse (gradients want |psi> = V(theta)^dag U |0>)."""
        if self.rhs_gate_count == 0:
            return self._current_state()
        rhs_rng = (len(self.full_circuit.data) - self.rhs_gate_count,
                   len(self.full_circuit.data))
        rhs_tape = compile_tape(self.full_circuit, rhs_rng)
        if self._current_cache is not None and not np.any(
                _tape_has_2q(rhs_tape)):
            # peel the rhs 1q gates off the cached full state instead of
            # re-simulating the whole unabsorbed tape: 1q adjoints are exact
            # (no bond truncation), and the cache is hot after every layer's
            # sweeps — at 50q this replaces ~200 bond SVDs with ~50 O(chi^2)
            # contractions per pair-scoring call
            return self.backend.run_tape_adjoint(self._current_cache,
                                                 rhs_tape)
        state = self._prefix_state()
        rng = (self.lhs_gate_count,
               len(self.full_circuit.data) - self.rhs_gate_count)
        if rng[1] > rng[0]:
            tape = compile_tape(self.full_circuit, rng)
            state = self.backend.run_tape(state, tape)
        return state

    def _find_best_entanglement_qubit_pair(self, entanglement_measures):
        """adapt_compiler.py:858-921."""
        priorities = self._get_all_qubit_pair_reuse_priorities(
            self.adapt_config.reuse_exponent)

        if len(self.entanglement_measures_history) >= 2 + int(
                self.initial_single_qubit_layer):
            prev_index = self.coupling_map.index(self.qubit_pair_history[-1])
            pre_em = self.entanglement_measures_history[-2][prev_index]
            post_em = self.entanglement_measures_history[-1][prev_index]
            if post_em >= pre_em:
                logger.debug(
                    f"pair {self.coupling_map[prev_index]} left its "
                    "entanglement unchanged or higher -> marking it bad")
                self.bad_qubit_pairs.append(self.coupling_map[prev_index])
            if len(self.bad_qubit_pairs) > self.adapt_config.bad_qubit_pair_memory:
                logger.debug(
                    f"bad-pair memory full; forgetting oldest entry "
                    f"{self.bad_qubit_pairs[0]}")
                del self.bad_qubit_pairs[0]

        logger.debug(f"per-pair entanglement: {entanglement_measures}")
        filtered = [em * pr for em, pr in zip(entanglement_measures, priorities)]
        for qp in set(self.bad_qubit_pairs):
            reps = len([x for x in self.qubit_pair_history[
                -self.adapt_config.bad_qubit_pair_memory:] if x == qp])
            if reps >= 1:
                filtered[self.coupling_map.index(qp)] = -1

        logger.debug(f"entanglement x reuse priority per pair: {filtered}")
        if max(filtered) <= self.adapt_config.entanglement_threshold:
            logger.info("every non-bad pair is below the entanglement threshold; "
                        "falling back to the expectation heuristic")
            return self._find_best_expectation_qubit_pair()
        self.pair_selection_method_history.append("ISL")
        self.e_val_history.append(None)
        return self.coupling_map[int(np.argmax(filtered))]

    def _find_best_expectation_qubit_pair(self):
        """adapt_compiler.py:923-953."""
        priorities = self._get_all_qubit_pair_reuse_priorities(
            self.adapt_config.reuse_exponent)
        e_vals = self.backend.measure_qubit_expectation_values(self)
        self.e_val_history.append(e_vals)
        e_val_sums = [e_vals[c] + e_vals[t] for c, t in self.coupling_map]
        logger.debug(f"pairwise <Z>+<Z> sums: {e_val_sums}")
        # map <Z> in [-1, 1] to a priority favouring qubits near |1>
        e_val_priorities = [2 - s for s in e_val_sums]
        combined = [e * p for e, p in zip(e_val_priorities, priorities)]
        logger.debug(f"expectation x reuse priority per pair: {combined}")
        self.pair_selection_method_history.append("expectation")
        return self.coupling_map[int(np.argmax(combined))]

    def _get_all_qubit_pair_entanglement_measures(self):
        """Batched on-device RDM sweep (adapt_compiler.py:955-976). For the
        sampling backend with the observable method, run the genuine two-copy
        Bell-measurement protocol per pair instead of post-processing RDMs
        (entanglement_measures.py:138-256)."""
        from ..backends.backend import SamplingBackend
        from ..utils.entanglement_measures import (
            EM_OBSERVABLE_CONCURRENCE_LOWER_BOUND,
            measure_concurrence_lower_bound)
        if (self.entanglement_measure_method
                == EM_OBSERVABLE_CONCURRENCE_LOWER_BOUND
                and isinstance(self.backend, SamplingBackend)):
            qc = co.make_quantum_only_circuit(self.full_circuit)
            return [measure_concurrence_lower_bound(
                        qc, a, b, self.backend,
                        execute_kwargs=self.execute_kwargs)
                    for a, b in self.coupling_map]
        state = self.backend.state_of(self)
        pairs = np.asarray(self.coupling_map, dtype=np.int32)
        rhos = self.backend.all_pair_rdms(state, pairs)
        return [measure_from_rdm(self.entanglement_measure_method, rho)
                for rho in rhos]

    # -------------------------------------------------------- reuse priority
    def _get_all_qubit_pair_reuse_priorities(self, k):
        """adapt_compiler.py:984-998."""
        if not len(self.qubit_pair_history):
            return [1 for _ in range(len(self.coupling_map))]
        priorities = []
        for qp in self.coupling_map:
            if self.adapt_config.reuse_priority_mode == "pair":
                priorities.append(self._get_pair_reuse_priority(qp, k))
            elif self.adapt_config.reuse_priority_mode == "qubit":
                priorities.append(self._get_qubit_reuse_priority(qp, k))
            else:
                raise ValueError("Reuse priority mode must be one of: "
                                 "['pair', 'qubit']")
        logger.debug(f"reuse priority per pair: {priorities}")
        return priorities

    def _find_last_use_of_qubit(self, qubit_pairs, qubit):
        for index, tup in enumerate(qubit_pairs):
            if qubit in tup:
                return index
        return np.inf

    def _get_qubit_reuse_priority(self, qubit_pair, k):
        """adapt_compiler.py:1006-1035."""
        if (len(self.qubit_pair_history) > 0 + int(self.initial_single_qubit_layer)
                and qubit_pair == self.qubit_pair_history[-1]):
            return -1
        if k == 0:
            return 1
        reversed_pairs = self.qubit_pair_history[::-1]
        locs = [self._find_last_use_of_qubit(reversed_pairs, q)
                for q in qubit_pair]
        return np.min([1 - np.exp2(-(loc + 1) / k) for loc in locs])

    def _get_pair_reuse_priority(self, qubit_pair, k):
        """adapt_compiler.py:1037-1065."""
        if (len(self.qubit_pair_history) > 0 + int(self.initial_single_qubit_layer)
                and qubit_pair == self.qubit_pair_history[-1]):
            return -1
        if k == 0:
            return 1
        reversed_pairs = self.qubit_pair_history[::-1]
        try:
            loc = reversed_pairs.index(qubit_pair)
            return 1 - np.exp2(-loc / k)
        except ValueError:
            return 1

    def _first_layer_increment_results_dict(self):
        self.entanglement_measures_history.append([None])
        self.e_val_history.append(None)
        self.general_gradient_history.append(None)
        self.qubit_pair_history.append((None, None))
        self.pair_selection_method_history.append(None)

    def _get_num_gates_to_cache(self, n, includes_isql=False):
        return (len(self.layer_2q_gate.data) * (n - int(includes_isql))
                + self.full_circuit.num_qubits * int(includes_isql))

    # ------------------------------------------------------------ absorption
    def _absorb_n_gates_into_mps(self, n) -> Circuit:
        """Advance the cached MPS prefix past the first n variational gates
        (adapt_compiler.py:1097-1145: the reference re-simulates into a
        set_matrix_product_state instruction; here the prefix state simply
        absorbs the gates on device)."""
        if n <= 0:
            return Circuit(self.full_circuit.num_qubits)
        rng = (self.lhs_gate_count, self.lhs_gate_count + n)
        gates_absorbed = co.extract_inner_circuit(self.full_circuit, rng)

        state = self._prefix_state()
        tape = compile_tape(self.full_circuit, rng)
        new_prefix = self.backend.run_tape(state, tape)

        # replace [prefix-instr, absorbed gates...] with one set_mps instr
        co.remove_inner_circuit(self.full_circuit, (0, rng[1]))
        marker = Circuit(self.full_circuit.num_qubits)
        marker.set_mps(new_prefix)
        self.full_circuit.data.insert(0, marker.data[0])
        self.lhs_gate_count = 1
        # absorption only moves the prefix/tape boundary — the state of the
        # whole circuit is unchanged, so keep the (expensive) current-state
        # cache and seed the prefix cache with the state just computed
        current = self._current_cache
        self._invalidate_prefix()
        self._prefix_cache = (self.lhs_gate_count, new_prefix)
        self._current_cache = current
        return gates_absorbed

    def _log_full_ansatz(self):
        """debug_log_full_ansatz: dump the current variational ansatz as QASM
        at debug level after every layer (adapt_compiler.py:508-534)."""
        if not self.debug_log_full_ansatz:
            return
        if self.is_mps_backend:
            src = self.ref_circuit_as_gates
            rng = (1, len(src.data))
        else:
            src = self.full_circuit
            rng = self.g_range()
        ansatz = co.extract_inner_circuit(src, rng)
        logger.debug("current full ansatz:\n%s",
                     qasm.dumps(co.make_quantum_only_circuit(ansatz)))

    def record_cnot_depth(self):
        """adapt_compiler.py:1147-1163."""
        if self.is_mps_backend:
            ref = self.ref_circuit_as_gates
            ansatz = co.extract_inner_circuit(ref, (1, len(ref.data)))
        else:
            ansatz = co.extract_inner_circuit(
                self.full_circuit, (self.original_lhs_gate_count,
                                    self.variational_circuit_range()[1]))
        self.cnot_depth = ansatz.multi_qubit_gate_depth()
        self.cnot_depth_history.append(self.cnot_depth)
