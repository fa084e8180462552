"""ApproximateCompiler: base class owning the full-circuit construction,
backend plumbing, cost evaluation and solution extraction.

API mirror of /root/reference/adaptaqc/compilers/approximate_compiler.py.
The "full circuit" identity is the same as the reference's
(:435-512): |0> -> [initial_state] -> [target U] -> (variational V^dag grows
here) -> [initial_state^-1] -> [starting_circuit^-1]; the cost is the
probability of returning to |0...0>.

Device-side inversion: the target prefix is simulated ONCE into an on-device engine
state (statevector or MPS) and cached; every cost query just applies the
variational tape to it (cf. the reference re-simulating the whole circuit in
Aer per query, :514-527 -> aer_sv_backend.py:37-47).
"""

from __future__ import annotations

import logging
import timeit
from abc import ABC, abstractmethod

import numpy as np

from ..backends import mps_core
from ..backends.backend import (AQCBackend, MPSBackend, SamplingBackend,
                                SVBackend, QASM_SIM)
from ..circuits import operations as co
from ..circuits.circuit import Circuit, unroll_to_basis_gates
from ..circuits.division import vertically_divide_circuit
from ..circuits.tape import compile_tape
from ..ops import cplx
from ..optim.minimiser import CostMinimiser

logger = logging.getLogger(__name__)


def _wall_deadline_passed():
    """Optional hard wall-clock stop for time-boxed benchmark runs.

    ``ADAPTAQC_WALL_DEADLINE=<unix epoch seconds>``: when set and passed,
    layer loops stop with the best-so-far ansatz so downstream cleanup,
    verification and record writing still run — a SIGTERM from ``timeout``
    would instead lose the whole multi-hour record (the reference has no
    equivalent knob; its Aer runs are interactive)."""
    import os
    ddl = os.environ.get("ADAPTAQC_WALL_DEADLINE")
    if not ddl:
        return False
    import time
    return time.time() >= float(ddl)


class CompileInPartsResult:
    def __init__(self, circuit, overlap, individual_results, time_taken):
        """
        :param circuit: Resulting circuit.
        :param overlap: 1 - final_global_cost.
        :param individual_results: Result objects of each sub-compilation.
        :param time_taken: Total time taken.
        """
        self.circuit = circuit
        self.overlap = overlap
        self.individual_results = individual_results
        self.time_taken = time_taken


def is_statevector_backend(backend) -> bool:
    return isinstance(backend, SVBackend)


class ApproximateCompiler(ABC):
    """Variational compiler base (approximate_compiler.py:64)."""

    def __init__(self, target, backend: AQCBackend, execute_kwargs=None,
                 initial_state=None, qubit_subset=None,
                 general_initial_state=False, starting_circuit=None,
                 optimise_local_cost=False, soften_global_cost=False,
                 rotosolve_fraction=1.0, zigzag=None, start_variant=0,
                 **_compat_kwargs):
        self.target = target
        # start_variant re-rolls the chaotic ADAPT trajectory without changing
        # the prepared state: variant k > 0 draws the (physically inert,
        # global-phase-only) leading Rz angles of the product-state starting
        # triple from rng(k). Used for multi-start retries on hard targets.
        self.start_variant = int(start_variant)
        self.original_circuit_classical_ops = None
        self.gate_circuit_to_compile = None  # set by prepare_circuit
        self.backend = backend if backend is not None else QASM_SIM
        self.is_statevector_backend = is_statevector_backend(self.backend)
        self.is_aer_mps_backend = isinstance(self.backend, MPSBackend)
        self.is_mps_backend = self.is_aer_mps_backend
        if mps_core.check_mps(self.target) and not self.is_mps_backend:
            raise Exception("MPS backend must be used when target is an MPS")
        self.circuit_to_compile = self.prepare_circuit()
        self.execute_kwargs = self.parse_default_execute_kwargs(execute_kwargs)
        self.backend_options = {}
        self.initial_state_circuit = co.initial_state_to_circuit(initial_state)
        self.total_num_qubits = self.calculate_total_num_qubits()
        self.qubit_subset_to_compile = (
            qubit_subset if qubit_subset else list(range(self.total_num_qubits)))
        self.general_initial_state = general_initial_state
        self.starting_circuit = self.prepare_starting_circuit(starting_circuit)
        self.optimise_local_cost = optimise_local_cost
        self.soften_global_cost = soften_global_cost

        if initial_state is not None and general_initial_state:
            raise ValueError("Can't compile for general initial state when "
                             "specific initial state is provided")

        (self.full_circuit, self.lhs_gate_count,
         self.rhs_gate_count) = self._prepare_full_circuit()

        if 0 < rotosolve_fraction <= 1:
            self.minimizer = CostMinimiser(self.evaluate_cost,
                                           self.variational_circuit_range,
                                           self, rotosolve_fraction,
                                           zigzag=zigzag)
        else:
            raise ValueError("rotosolve_fraction must be in the range (0,1]")

        self.cost_evaluation_counter = 0
        self.compiling_finished = False
        self._prefix_cache = None   # (lhs_count, engine state)
        self._current_cache = None

    # --------------------------------------------------------- construction
    def prepare_circuit(self) -> Circuit:
        """Target -> circuit to compile (approximate_compiler.py:165-217)."""
        if mps_core.check_mps(self.target):
            if isinstance(self.target, mps_core.MPS):
                n = self.target.n
            else:
                n = len(self.target[0])
            qc = Circuit(n)
            qc.set_mps(self.target)
            return qc
        target_copy = self.target.copy()
        self.original_circuit_classical_ops = co.remove_classical_operations(
            target_copy)
        prepared = unroll_to_basis_gates(target_copy)
        # keep the gate-level target: for MPS backends circuit_to_compile
        # becomes the set_mps wrapper, which cannot be depth-divided
        # (compile_in_parts) or re-simulated gate-by-gate
        self.gate_circuit_to_compile = prepared
        if self.is_mps_backend:
            logger.info("Pre-computing target circuit as MPS on device")
            target_mps = self.backend.mps_from_compiler_target(prepared)
            qc = Circuit(prepared.num_qubits)
            qc.set_mps(target_mps)
            return qc
        return prepared

    def prepare_starting_circuit(self, starting_circuit):
        """approximate_compiler.py:219-246; 'tenpy_product_state' is replaced
        by an on-device chi=1 variational compression of the target MPS."""
        if starting_circuit is None or isinstance(starting_circuit, Circuit):
            return starting_circuit
        if starting_circuit in ("tenpy_product_state", "product_state"):
            from ..utils.compression import best_product_state_circuit
            return best_product_state_circuit(self)
        raise ValueError("starting_circuit must be a Circuit, None, or the "
                         "string 'tenpy_product_state'")

    def parse_default_execute_kwargs(self, execute_kwargs):
        kwargs = {} if execute_kwargs is None else dict(execute_kwargs)
        if "shots" not in kwargs:
            kwargs["shots"] = 8192 if isinstance(self.backend, SamplingBackend) else 1
        if "optimization_level" not in kwargs:
            kwargs["optimization_level"] = 0
        if isinstance(self.backend, SamplingBackend):
            self.backend.shots = kwargs["shots"]
        return kwargs

    def calculate_total_num_qubits(self):
        if self.initial_state_circuit is None:
            return self.circuit_to_compile.num_qubits
        return self.initial_state_circuit.num_qubits

    def _prepare_full_circuit(self):
        """approximate_compiler.py:435-512."""
        total_qubits = (2 * self.total_num_qubits if self.general_initial_state
                        else self.total_num_qubits)
        qc = Circuit(total_qubits)

        if self.initial_state_circuit is not None:
            co.add_to_circuit(qc, unroll_to_basis_gates(self.initial_state_circuit))
        elif self.general_initial_state:
            for qubit in range(self.total_num_qubits):
                qc.h(qubit)
                qc.cx(qubit, qubit + self.total_num_qubits)

        co.add_to_circuit(qc, self.circuit_to_compile,
                          qubit_subset=self.qubit_subset_to_compile)
        lhs_gate_count = len(qc.data)

        if self.initial_state_circuit is not None:
            isc = unroll_to_basis_gates(self.initial_state_circuit)
            co.add_to_circuit(qc, isc.inverse())
        if self.starting_circuit is not None:
            co.add_to_circuit(qc, self.starting_circuit.inverse())
        elif self.general_initial_state:
            for qubit in range(self.total_num_qubits - 1, -1, -1):
                qc.cx(qubit, qubit + self.total_num_qubits)
                qc.h(qubit)

        if isinstance(self.backend, SamplingBackend):
            qc.num_clbits = 1 if self.optimise_local_cost else total_qubits
            # measures are implicit: the sampling backend samples the final
            # state directly (the reference appends measure gates here,
            # :502-508; our IR leaves them out of the simulated tape anyway)

        rhs_gate_count = len(qc.data) - lhs_gate_count
        return qc, lhs_gate_count, rhs_gate_count

    # ------------------------------------------------------- state plumbing
    def _prefix_state(self):
        """Engine state after full_circuit.data[:lhs_gate_count], cached."""
        if self._prefix_cache is not None and \
                self._prefix_cache[0] == self.lhs_gate_count:
            return self._prefix_cache[1]
        qc = self.full_circuit
        n = qc.num_qubits
        state = self.backend.initial_state(qc, n)
        start = 1 if (qc.data and qc.data[0].name in
                      ("set_mps", "set_statevector")) else 0
        if self.lhs_gate_count > start:
            tape = compile_tape(qc, (start, self.lhs_gate_count))
            state = self.backend.run_tape(state, tape)
        self._prefix_cache = (self.lhs_gate_count, state)
        return state

    def _invalidate_prefix(self):
        self._prefix_cache = None
        self._current_cache = None

    def _invalidate_current(self):
        self._current_cache = None

    def _current_state(self):
        """Engine state of the whole full_circuit, cached until mutation."""
        if self._current_cache is not None:
            return self._current_cache
        state = self._prefix_state()
        rng = (self.lhs_gate_count, len(self.full_circuit.data))
        if rng[1] > rng[0]:
            tape = compile_tape(self.full_circuit, rng)
            state = self.backend.run_tape(state, tape)
        self._current_cache = state
        return state

    # ------------------------------------------------------------ cost layer
    def variational_circuit_range(self, circuit=None):
        if circuit is None:
            circuit = self.full_circuit
        return self.lhs_gate_count, len(circuit.data) - self.rhs_gate_count

    def ansatz_range(self):
        return self.lhs_gate_count, len(self.full_circuit.data)

    def _starting_circuit_range(self):
        end = len(self.full_circuit.data)
        return end - self.rhs_gate_count, end

    def evaluate_cost(self):
        """approximate_compiler.py:514-527."""
        self.cost_evaluation_counter += 1
        if self.optimise_local_cost:
            return self.backend.evaluate_local_cost(self)
        return self.backend.evaluate_global_cost(self)

    @abstractmethod
    def compile(self):
        raise NotImplementedError(
            "A compiler must provide implementation for the compile() method")

    # --------------------------------------------------------------- results
    def get_compiled_circuit(self) -> Circuit:
        """Invert the optimised ansatz, prepend starting_circuit, restore
        classical ops (approximate_compiler.py:385-433)."""
        compiled = co.circuit_by_inverting_circuit(
            co.extract_inner_circuit(self.full_circuit,
                                     self.variational_circuit_range()))
        if self.starting_circuit is not None:
            co.add_to_circuit(compiled, self.starting_circuit, 0)
        final = Circuit(self.circuit_to_compile.num_qubits,
                        self.circuit_to_compile.num_clbits)
        qubit_map = {full: sub for sub, full in
                     enumerate(self.qubit_subset_to_compile)}
        co.add_to_circuit(final, compiled, qubit_subset=qubit_map)
        if self.original_circuit_classical_ops is not None:
            co.add_classical_operations(final, self.original_circuit_classical_ops)
        return final

    def compile_in_parts(self, max_depth_per_block=10, initial_ansatz=None,
                         start_part=0, part_callback=None,
                         reoptimise_carried="auto") -> CompileInPartsResult:
        """Ladder compilation, following the reference's stated contract
        (approximate_compiler.py:321-331): part k approximately compiles the
        first k depth-blocks of the target, warm-started from part k-1's
        solution.

        Beyond-reference resume support (a multi-hour 50q ladder must
        survive a queue timeout): ``start_part=k`` skips compiling blocks
        0..k-1 — their gates still extend the engine target prefix — and
        warm-starts part k from ``initial_ansatz`` (the saved solution of a
        previous run's part k-1). ``part_callback(i, result, circuit)``
        fires after each part completes so callers can checkpoint the
        carried solution; callback exceptions are the caller's problem.

        Deviation note (docs/PARITY.md): the reference's in-place loop
        (:343-366) inserts each block into the variational region of a
        full_circuit that still carries the COMPLETE target on the LHS (no
        upstream test exercises it end-to-end), which makes every part as
        hard as the whole compile — measured on the 50q fig5 workload, part 1
        pins at cost 1.0. Re-derived here to match the documented semantics:
        the cumulative block prefix is simulated incrementally into the
        engine target state, and each part is a fresh compile of that prefix
        with the carried solution passed as ``initial_ansatz`` (one
        whole-range re-optimisation, then frozen into the prefix).

        ``reoptimise_carried`` (VERDICT r4 next #4 — carried-fidelity
        preservation): both engine paths freeze the carried ansatz right
        after ``_add_initial_ansatz`` (MPS: absorbed into the prefix; SV:
        lhs_gate_count advances), so the ONLY step that can move carried
        angles is that method's single whole-range rotosolve — which at 50q
        chases a chi-capped surrogate and measurably destroys part k-1's
        fidelity (part overlaps [0.9999, 0.8257]). Modes:

        - ``"never"``: carried angles are untouched; ADAPT layers learn the
          dressed new block only.
        - ``"always"``: the pre-r5 behaviour (whole-range re-optimisation).
        - ``"auto"`` (default): freeze first; if the part's verified
          overlap misses the sufficient threshold, retry that part once
          with the whole-range re-optimisation and keep the better result
          (widen only when the verified cost demands it)."""
        logger.info("Started partial recompilation")
        start_time = timeit.default_timer()
        # divide the gate-level target: for MPS backends circuit_to_compile
        # is the set_mps wrapper, which has no depth structure to divide
        gate_target = self.gate_circuit_to_compile
        if gate_target is None:
            raise ValueError(
                "compile_in_parts needs a gate-level target circuit; an MPS "
                "target has no depth structure to divide into blocks")
        all_subcircuits = vertically_divide_circuit(
            gate_target.copy(), max_depth_per_block)
        logger.info(f"Circuit was split into {len(all_subcircuits)} parts to "
                    "compile sequentially")

        if not 0 <= start_part < len(all_subcircuits):
            raise ValueError(
                f"start_part {start_part} out of range for "
                f"{len(all_subcircuits)}-part division")
        if start_part > 0 and initial_ansatz is None:
            raise ValueError("resuming at start_part > 0 requires the "
                             "previous run's carried solution as "
                             "initial_ansatz")

        prefix = Circuit(gate_target.num_qubits)  # cumulative gate prefix
        prefix_state = None  # incrementally extended target MPS (MPS backends)
        last_compiled = None
        individual_results = []
        for i, subcircuit in enumerate(all_subcircuits):
            co.add_to_circuit(prefix, subcircuit.copy())
            if self.is_mps_backend:
                prefix_state = self.backend.mps_from_compiler_target(
                    subcircuit, start_state=prefix_state)
                part_target = prefix_state
            else:
                part_target = prefix.copy()
            if i < start_part:
                continue  # resumed: this block was compiled in a prior run
            part_compiler = self._clone_with_target(part_target)
            warm_start = last_compiled
            if warm_start is None:
                warm_start = (initial_ansatz if initial_ansatz is not None
                              else self.starting_circuit)
            carried = warm_start is not None and i > 0
            freeze_first = carried and reoptimise_carried in ("auto", "never")
            result = part_compiler.compile(
                initial_ansatz=warm_start,
                optimise_initial_ansatz=not freeze_first)
            if (freeze_first and reoptimise_carried == "auto"
                    and result.overlap < self._part_overlap_target()
                    and not _wall_deadline_passed()):
                logger.info(
                    f"part {i}: frozen-carried attempt ended at verified "
                    f"overlap {result.overlap:.4f} < target — widening to a "
                    f"whole-range re-optimisation of the carried ansatz")
                retry_compiler = self._clone_with_target(part_target)
                retry = retry_compiler.compile(initial_ansatz=warm_start,
                                               optimise_initial_ansatz=True)
                if retry.overlap > result.overlap:
                    result = retry
            last_compiled = result.circuit
            result.circuit = None
            individual_results.append(result)
            logger.info(f"Completed {100 * (i + 1) / len(all_subcircuits)}% "
                        "of recompilation")
            if part_callback is not None:
                part_callback(i, result, last_compiled)

        end_time = timeit.default_timer()
        return CompileInPartsResult(
            circuit=last_compiled,
            overlap=calculate_overlap_between_circuits(
                last_compiled, gate_target,
                self.initial_state_circuit, self.qubit_subset_to_compile),
            individual_results=individual_results,
            time_taken=end_time - start_time)

    def _clone_with_target(self, target):
        """Fresh compiler of the same configuration for one ladder part.
        Subclasses capture their construction knobs to implement this."""
        raise NotImplementedError(
            "compile_in_parts requires the compiler to implement "
            "_clone_with_target")

    def _part_overlap_target(self) -> float:
        """Verified-overlap bar a ladder part must clear before 'auto' mode
        skips the carried-ansatz re-optimisation (1 - sufficient_cost for
        ADAPT compilers, 0.99 otherwise)."""
        cfg = getattr(self, "adapt_config", None)
        return 1.0 - (cfg.sufficient_cost if cfg is not None else 1e-2)


# Above this, a dense 2^n statevector no longer fits and overlaps switch to
# the MPS engine (the reference's dense-only helper, full_circuit.py:413-438,
# simply cannot evaluate its compile_in_parts result at 50 qubits).
DENSE_OVERLAP_MAX_QUBITS = 26


def calculate_overlap_between_circuits(circuit1: Circuit, circuit2: Circuit,
                                       initial_state=None, qubit_subset=None,
                                       mps_chi: int = 64):
    """|<psi1|psi2>|^2 (full_circuit.py:413-438) — dense statevector
    simulation up to DENSE_OVERLAP_MAX_QUBITS, MPS contraction at bond cap
    `mps_chi` beyond (norm-normalised: chi >> true-rank f32 chains drift in
    scale, see docs/design_notes.md)."""
    initial_state_circuit = co.initial_state_to_circuit(initial_state)
    if initial_state_circuit is None:
        total = circuit1.num_qubits
    else:
        total = initial_state_circuit.num_qubits
    subset = qubit_subset if qubit_subset else list(range(total))

    from ..backends import sv_core

    def build(circ):
        qc = Circuit(total)
        if initial_state_circuit is not None:
            co.add_to_circuit(qc, initial_state_circuit)
        co.add_to_circuit(qc, co.make_quantum_only_circuit(circ),
                          qubit_subset=subset)
        return qc

    def run_dense(qc):
        if qc.data and qc.data[0].name == "set_statevector":
            state = sv_core.state_from_vector(qc.data[0].payload)
            start = 1
        else:
            state = sv_core.zero_state(total)
            start = 0
        tape = compile_tape(qc, (start, len(qc.data)))
        return sv_core.apply_tape(state, *(np.asarray(x) for x in
                                           (tape.kinds, tape.q0, tape.q1,
                                            tape.angles)))

    def run_mps(qc):
        import jax.numpy as jnp
        if qc.data and qc.data[0].name == "set_mps":
            state = mps_core.from_qiskit_mps(qc.data[0].payload, mps_chi)
            start = 1
        else:
            state = mps_core.zero_mps(total, mps_chi)
            start = 0
        tape = compile_tape(qc, (start, len(qc.data)))
        return mps_core.apply_tape(
            state, *(jnp.asarray(x) for x in
                     (tape.kinds, tape.q0, tape.q1, tape.angles)), 1e-16)

    if total <= DENSE_OVERLAP_MAX_QUBITS:
        s1 = cplx.to_np(run_dense(build(circuit1)))
        s2 = cplx.to_np(run_dense(build(circuit2)))
        return float(np.absolute(np.vdot(s1, s2)) ** 2)
    m1 = run_mps(build(circuit1))
    m2 = run_mps(build(circuit2))
    n1 = float(mps_core.mps_dot(m1, m1).re)
    n2 = float(mps_core.mps_dot(m2, m2).re)
    return float(mps_core.mps_dot(m1, m2).abs2() / max(n1 * n2, 1e-30))
