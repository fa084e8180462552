"""Paper workload: 50-qubit random-MPS preparation (arXiv:2503.09683).

Compiles the reference repo's actual benchmark targets
(/root/reference/paper/random_mps/target_seed_*.pkl — 50-site chi=2 random
MPS in the Qiskit MPS format) with the paper's configuration
(general_gradient method, identity_resolvable ansatz, chi=1-compression
start; examples/advanced_mps_example.py in the reference) and reports the
BASELINE.md north-star metrics: wall-clock to overlap > 0.99, layer count,
and cost-evaluation throughput.

Usage: python benchmarks/random_mps.py [seed ...]
"""

import logging
import os
import pickle
import sys
import time

import numpy as np

logging.basicConfig(stream=sys.stderr)
logging.getLogger("adaptaqc_tpu").setLevel(logging.INFO)

REFERENCE_TARGETS = "/root/reference/paper/random_mps"


sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _common import (compile_with_recovery, git_rev as _git_rev,
                     platform as _platform, save_circuit as _save_circuit)


def load_target(seed: int):
    with open(f"{REFERENCE_TARGETS}/target_seed_{seed}.pkl", "rb") as f:
        return pickle.load(f)


def random_target(seed: int, n=50, chi=2):
    """Self-contained substitute when the reference data is unavailable: a
    random low-chi MPS in Qiskit format, built CANONICALLY by evolving |0>
    with a random brickwall of 2q gates at bond cap `chi` and exporting
    (a haphazard Gamma/lambda draw is not a valid Vidal-canonical state)."""
    import jax.numpy as jnp
    from adaptaqc_tpu.backends import mps_core
    from adaptaqc_tpu.circuits.circuit import Circuit
    from adaptaqc_tpu.circuits.tape import compile_tape

    rng = np.random.default_rng(seed)
    qc = Circuit(n)
    for q in range(n):
        qc.ry(float(rng.uniform(-3, 3)), q)
    for layer in range(2):
        for q in range(layer % 2, n - 1, 2):
            qc.cx(q, q + 1)
        for q in range(n):
            qc.rz(float(rng.uniform(-3, 3)), q)
    tape = compile_tape(qc)
    state = mps_core.apply_tape(
        mps_core.zero_mps(n, chi), jnp.asarray(tape.kinds),
        jnp.asarray(tape.q0), jnp.asarray(tape.q1),
        jnp.asarray(tape.angles), 1e-16)
    return mps_core.to_qiskit_mps(state)


def make_compiler(qmps, max_chi, sufficient_cost, max_layers,
                  method="general_gradient", mesh=None):
    """The paper's AdaptCompiler configuration for a qiskit-format MPS
    target, on the MPS backend at working bond dimension ``max_chi``
    (bond-sharded over ``mesh`` when one is given)."""
    import os
    from adaptaqc_tpu import AdaptCompiler, AdaptConfig, MPSBackend
    from adaptaqc_tpu.utils.ansatzes import identity_resolvable
    from adaptaqc_tpu.utils.constants import CMAP_LINEAR, generate_coupling_map

    n = len(qmps[0])
    # reference-default rotosolve schedule (rotosolve_frequency=1,
    # max_layers_to_modify=100): the trailing window is re-optimised after
    # every layer — weakening this (e.g. frequency 10 / window 10) plateaus
    # well short of 0.99 overlap on the paper targets
    # patience: the 50q targets have long slow stretches before late, fast
    # convergence phases; a tight improvement window stops at overlap ~0.98
    config = AdaptConfig(
        method=method,
        cost_improvement_num_layers=1000,
        sufficient_cost=sufficient_cost,
        max_layers=max_layers,
        # hybrid local-cost schedule knobs (only read when RMPS_LOCAL=1)
        local_window_layers=int(os.environ.get("RMPS_LOCAL_WINDOW", 16)),
        global_polish_frequency=int(os.environ.get("RMPS_POLISH_FREQ", 10)),
    )
    backend = MPSBackend(truncation_threshold=1e-8, max_chi=max_chi,
                         mesh=mesh)
    compiler = AdaptCompiler(
        qmps, backend=backend, adapt_config=config,
        coupling_map=generate_coupling_map(n, CMAP_LINEAR),
        custom_layer_2q_gate=identity_resolvable(),
        starting_circuit="tenpy_product_state",
        # trajectories are chaotically start-sensitive; variant k > 0 retries
        # the same problem from a state-identical (global-phase-only) start
        start_variant=int(os.environ.get("RMPS_START_VARIANT", 0)),
        # RMPS_LOCAL=1: train on the local (per-qubit) cost — the
        # reference's barren-plateau answer for large n
        # (docs/running_options_explained.md local_cost_function section);
        # result.overlap stays the global overlap either way
        optimise_local_cost=bool(int(os.environ.get("RMPS_LOCAL", "0"))),
    )
    return compiler


def compile_target(qmps, max_chi=None, sufficient_cost=None, max_layers=None,
                   method="general_gradient", tag=None):
    import os
    if sufficient_cost is None:
        # default 9.5e-3, NOT the reference's 1e-2: a stop at exactly cost
        # 1e-2 records an overlap that rounds to 0.9900 and fails a strict
        # >0.99 tally (seeds 57/69/78/80/81 each cost a whole refinement
        # pass to push past it); the 0.5e-3 margin is one or two extra
        # layers at the stop point
        sufficient_cost = float(os.environ.get("RMPS_SUFF", 9.5e-3))
    if max_chi is None:
        # working bond dimension; sufficient-cost stops are verified against
        # an exact re-simulation of the cleaned circuit, and every record
        # carries an independent chi=64 re-check of the final overlap
        max_chi = int(os.environ.get("RMPS_CHI", 32))
    if max_layers is None:
        # the paper's hardest targets run to ~1226 CZ = ~600 identity-
        # resolvable layers; 800 leaves margin (RMPS_LAYERS to override)
        max_layers = int(os.environ.get("RMPS_LAYERS", 800))
    compiler = make_compiler(qmps, max_chi, sufficient_cost, max_layers,
                             method)
    t0 = time.time()
    compiler, result = compile_with_recovery(
        compiler, tag or f"rmps_n{len(qmps[0])}_chi{max_chi}")
    wall = time.time() - t0
    return result, wall


def independent_overlap(qmps, circuit, chi=64):
    """|<target| circuit |0>|^2 re-simulated from scratch at bond dimension
    `chi` — an independent check of the compiler-reported overlap (matters
    when the compile itself ran at a smaller working chi)."""
    import jax.numpy as jnp
    from adaptaqc_tpu.backends import mps_core
    from adaptaqc_tpu.circuits.operations import make_quantum_only_circuit
    from adaptaqc_tpu.circuits.tape import compile_tape

    target = mps_core.from_qiskit_mps(qmps, chi)
    tape = compile_tape(make_quantum_only_circuit(circuit))
    state = mps_core.apply_tape(
        mps_core.zero_mps(len(qmps[0]), chi), jnp.asarray(tape.kinds),
        jnp.asarray(tape.q0), jnp.asarray(tape.q1),
        jnp.asarray(tape.angles), 1e-16)
    # normalised: chi >> true-rank f32 chains drift in scale (see
    # adapt_compiler._true_cost_of_gate_circuit)
    nrm2 = float(mps_core.mps_dot(state, state).re)
    tnrm2 = float(mps_core.mps_dot(target, target).re)
    return float(mps_core.mps_dot(target, state).abs2()
                 / max(nrm2 * tnrm2, 1e-30))


def main():
    import json
    import os
    seeds = [int(s) for s in sys.argv[1:]] or [1]
    results_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "results_random_mps.jsonl")
    n_override = int(os.environ.get("RMPS_N", 0))
    for seed in seeds:
        if n_override:
            # scale demonstration beyond the reference's 50q paper targets:
            # a synthetic canonical random MPS at RMPS_N qubits
            qmps = random_target(seed, n=n_override)
            source = f"synthetic n={n_override}"
        else:
            try:
                qmps = load_target(seed)
                source = "reference paper target"
            except OSError:
                qmps = random_target(seed)
                source = "synthetic fallback"
        result, wall = compile_target(
            qmps, tag=f"rmps_seed{seed}_n{n_override or 50}")
        layers = len(result.qubit_pair_history)
        overlap64 = independent_overlap(qmps, result.circuit)
        engine_ov = None
        try:
            if int(os.environ.get("RMPS_CROSS_ENGINE", "1")):
                from adaptaqc_tpu.utils.verification import \
                    cross_engine_overlap
                engine_ov = cross_engine_overlap(qmps, result.circuit, chi=64)
        except Exception as exc:  # pragma: no cover - benchmark resilience
            print(f"cross-engine check failed: {exc}", file=sys.stderr)
        # persist the compiled circuit so any record (especially surprising
        # overlap readings) can be re-simulated later without re-compiling
        circ_path = _save_circuit(result, f"seed_{seed}")
        record = {
            "seed": seed,
            "source": source,
            "n_qubits": len(qmps[0]),
            "overlap": round(result.overlap, 4),
            "overlap_chi64_check": round(overlap64, 4),
            "independent_engine_overlap": (
                None if engine_ov is None else round(engine_ov, 4)),
            "working_chi": int(os.environ.get("RMPS_CHI", 32)),
            "layers": layers,
            "num_2q_gates": result.num_2q_gates,
            "cnot_depth": result.cnot_depth_history[-1],
            "cost_evaluations": result.cost_evaluations,
            "wall_seconds": round(wall, 1),
            "evals_per_sec": round(result.cost_evaluations / wall, 1),
            "phase_timings": {k: round(v, 1) for k, v in
                              getattr(result, "phase_timings", {}).items()},
            "zigzag": bool(int(os.environ.get("ADAPTAQC_ZIGZAG", "0"))),
            "local_cost": bool(int(os.environ.get("RMPS_LOCAL", "0"))),
            "start_variant": int(os.environ.get("RMPS_START_VARIANT", 0)),
            "sufficient_cost": float(os.environ.get("RMPS_SUFF", 9.5e-3)),
            "circuit": circ_path,
            "build": _git_rev(),
            "platform": _platform(),
        }
        print(f"seed {seed}: overlap={result.overlap:.4f} "
              f"(chi64 check {overlap64:.4f}) layers={layers} "
              f"2q_gates={result.num_2q_gates} "
              f"cnot_depth={result.cnot_depth_history[-1]} "
              f"evals={result.cost_evaluations} wall={wall:.1f}s "
              f"({result.cost_evaluations / wall:.0f} evals/s)")
        with open(results_path, "a") as f:
            f.write(json.dumps(record) + "\n")


if __name__ == "__main__":
    main()
