"""Invariant tests for the engine-state reuse layer.

The optimiser seeds the compiler's full-state cache with the sweep's final
state, absorption preserves it across the prefix/tape boundary move, pair
scoring peels the starting circuit off it with exact 1q adjoints, and the
per-layer Rotoselect consumes a pre-insertion advance hint. Each of these
must be indistinguishable from a fresh re-simulation — these tests compare
every cached object against the from-scratch computation the reference
semantics imply (approximate_compiler.py:514-527 re-simulates per query).
"""

import numpy as np
import pytest

from adaptaqc_tpu import AdaptCompiler, AdaptConfig, MPSBackend, Circuit
from adaptaqc_tpu.backends import mps_core
from adaptaqc_tpu.circuits import operations as co
from adaptaqc_tpu.circuits.tape import compile_tape

from reference_sim import simulate
from test_sv_core import random_circuit


def _mps_compiler(n=4, seed=31, with_start=True):
    rng = np.random.default_rng(seed)
    qc = random_circuit(n, 10, rng)
    start = None
    if with_start:
        start = Circuit(n)
        for q in range(n):
            start.ry(float(rng.uniform(-1, 1)), q)
    return AdaptCompiler(qc, backend=MPSBackend(max_chi=8),
                         starting_circuit=start,
                         adapt_config=AdaptConfig(max_layers=3,
                                                  sufficient_cost=1e-12))


def _fresh_full_state(compiler):
    """Re-simulate the whole full_circuit from its target instruction,
    bypassing every cache."""
    qc = compiler.full_circuit
    state = compiler.backend.initial_state(qc, qc.num_qubits)
    start = 1 if qc.data and qc.data[0].name in ("set_mps",
                                                 "set_statevector") else 0
    rng = (start, len(qc.data))
    if rng[1] > rng[0]:
        state = compiler.backend.run_tape(state, compile_tape(qc, rng))
    return state


def test_current_cache_matches_fresh_resimulation():
    compiler = _mps_compiler()
    compiler.compile()
    # after compile the caches were rebuilt several times; run one more
    # layer-style optimisation to re-seed, then compare
    assert compiler._current_cache is not None
    cached = compiler._current_cache
    fresh = _fresh_full_state(compiler)
    np.testing.assert_allclose(mps_core.to_dense(cached),
                               mps_core.to_dense(fresh), atol=1e-5)


def test_state_without_starting_circuit_fast_path_matches_slow():
    compiler = _mps_compiler()
    compiler.compile()
    assert compiler._current_cache is not None
    fast = compiler._state_without_starting_circuit()
    compiler._invalidate_current()  # force the slow re-simulation branch
    slow = compiler._state_without_starting_circuit()
    np.testing.assert_allclose(mps_core.to_dense(fast),
                               mps_core.to_dense(slow), atol=1e-5)


def test_advance_hint_matches_direct_prefix():
    compiler = _mps_compiler(seed=33)
    compiler.compile()
    insert_at = compiler.variational_circuit_range()[1]
    compiler._stash_advance_hint(insert_at)
    assert compiler._advance_hint is not None
    idx, hint_state = compiler._advance_hint
    assert idx == insert_at
    qc = compiler.full_circuit
    state = compiler.backend.initial_state(qc, qc.num_qubits)
    start = 1 if qc.data[0].name in ("set_mps", "set_statevector") else 0
    direct = compiler.backend.run_tape(state,
                                       compile_tape(qc, (start, insert_at)))
    np.testing.assert_allclose(mps_core.to_dense(hint_state),
                               mps_core.to_dense(direct), atol=1e-5)


def test_absorption_preserves_current_cache():
    """Absorbing gates into the MPS prefix moves the prefix/tape boundary
    but not the physical state: the preserved cache must equal a fresh
    re-simulation of the post-absorption circuit."""
    rng = np.random.default_rng(34)
    qc = random_circuit(4, 10, rng)
    compiler = AdaptCompiler(
        qc, backend=MPSBackend(max_chi=8),
        adapt_config=AdaptConfig(max_layers=3, sufficient_cost=1e-12,
                                 rotosolve_frequency=1,
                                 max_layers_to_modify=1))
    compiler.compile()  # absorbs every finalised layer
    cached = compiler._current_cache
    assert cached is not None
    fresh = _fresh_full_state(compiler)
    np.testing.assert_allclose(mps_core.to_dense(cached),
                               mps_core.to_dense(fresh), atol=1e-5)


def test_compile_preserves_classical_operations():
    """Measurements and classical bits survive compilation (reference
    test_adapt_compiler.py cregs/measurement preservation tests)."""
    n = 3
    rng = np.random.default_rng(35)
    qc = random_circuit(n, 10, rng)
    qc.num_clbits = n
    for q in range(n):
        qc.measure(q, q)
    compiler = AdaptCompiler(qc)
    result = compiler.compile()
    assert result.overlap > 0.99
    assert result.circuit.num_clbits == n
    measures = [i for i in result.circuit.data if i.name == "measure"]
    assert len(measures) == n
    # the measured state must match the target (quantum-only comparison)
    sv_t = simulate(co.make_quantum_only_circuit(qc))
    sv_s = simulate(co.make_quantum_only_circuit(result.circuit))
    assert abs(np.vdot(sv_t, sv_s)) ** 2 > 0.97


def test_no_false_convergence_under_binding_chi():
    """With a binding chi cap the in-loop absorbed-prefix cost can read
    below sufficient_cost while the exact re-simulation does not; the
    compiler must verify before accepting the stop. Invariant: a compile
    never terminates early claiming success unless the final (exact,
    re-simulated) overlap actually clears the threshold."""
    rng = np.random.default_rng(37)
    qc = random_circuit(4, 12, rng)
    config = AdaptConfig(max_layers=40, sufficient_cost=1e-2,
                         cost_improvement_num_layers=float("inf"),
                         rotosolve_frequency=1, max_layers_to_modify=2)
    compiler = AdaptCompiler(qc, backend=MPSBackend(max_chi=2),
                             adapt_config=config)
    result = compiler.compile()
    stopped_early = len(result.qubit_pair_history) < config.max_layers
    if stopped_early:
        assert result.overlap > 1 - config.sufficient_cost


def test_true_cost_matches_exact_statevector_overlap():
    """The chi-doubled deliverable-side verification must equal the exact
    |<target|solution>|^2 at small n (where 2*chi covers the full Schmidt
    rank)."""
    rng = np.random.default_rng(38)
    qc = random_circuit(4, 10, rng)
    compiler = AdaptCompiler(qc, backend=MPSBackend(max_chi=8),
                             adapt_config=AdaptConfig(max_layers=3,
                                                      sufficient_cost=1e-12))
    result = compiler.compile()
    true_cost = compiler._true_cost_of_gate_circuit(compiler.full_circuit)
    sv_t = simulate(co.make_quantum_only_circuit(qc))
    sv_s = simulate(co.make_quantum_only_circuit(result.circuit))
    exact = 1.0 - abs(np.vdot(sv_t, sv_s)) ** 2
    assert abs(true_cost - exact) < 1e-4
    # the reported overlap IS this quantity
    assert abs((1.0 - result.overlap) - exact) < 1e-4


def test_global_cost_is_scale_invariant():
    """Chi buffers far above the state's true rank accumulate a pure SCALE
    drift on real hardware (Gram-eigh noise floor corrupts snorm; direction
    survives to ~1e-6 — measured norm^2 up to 1.18 at n=50, chi=128). The
    normalised cost paths must therefore be invariant under rescaling the
    engine state."""
    from adaptaqc_tpu.backends import mps_core
    from adaptaqc_tpu.ops.cplx import C

    rng = np.random.default_rng(39)
    qc = random_circuit(4, 10, rng)
    compiler = AdaptCompiler(qc, backend=MPSBackend(max_chi=8),
                             adapt_config=AdaptConfig(max_layers=2))
    compiler.compile()
    compiler._invalidate_current()
    base = compiler.backend.evaluate_global_cost(compiler)

    state = compiler.backend.state_of(compiler)
    scaled = mps_core.MPS(
        C(state.b.re.at[0].multiply(1.3), state.b.im.at[0].multiply(1.3)),
        state.lam, state.trunc)
    compiler._current_cache = scaled
    assert compiler.backend.evaluate_global_cost(compiler) == pytest.approx(
        base, abs=1e-6)

    # the softened cost must share the normalisation (penalty term included)
    compiler.soften_global_cost = True
    soft_scaled = compiler.backend.evaluate_global_cost(compiler)
    compiler._current_cache = state
    soft_base = compiler.backend.evaluate_global_cost(compiler)
    compiler.soften_global_cost = False
    assert soft_scaled == pytest.approx(soft_base, abs=1e-6)
    compiler._current_cache = scaled

    # the chi-doubled verification path is scale-invariant by construction
    cost = compiler._true_cost_of_gate_circuit(compiler.full_circuit)
    assert 0.0 <= cost <= 1.0 + 1e-6


def test_float_cost_improvement_num_layers_accepted():
    """The reference tolerates a float cost_improvement_num_layers
    (test_given_compiler_when_float_cost_improvement_num_layers_then_no_error)."""
    qc = random_circuit(3, 8, np.random.default_rng(36))
    for cinl in (8.0, float("inf")):
        config = AdaptConfig(cost_improvement_num_layers=cinl, max_layers=4)
        result = AdaptCompiler(qc, adapt_config=config).compile()
        assert result.overlap >= 0.0


def test_sweep_until_converged_with_init_state_matches():
    """Supplying the caller's full-state cache as init_state must be
    indistinguishable from the self-computed initial state (same kinds,
    angles, cost, cycle count, final state)."""
    import jax.numpy as jnp
    from adaptaqc_tpu.backends import sv_core
    from adaptaqc_tpu.optim import sweeps

    rng = np.random.default_rng(3)
    qc = random_circuit(4, 12, rng)
    tape = compile_tape(qc)
    engine = sv_core.sweep_engine()
    prefix = sv_core.zero_state(4)
    ref = sv_core.zero_state(4)
    args = (jnp.asarray(tape.kinds), jnp.asarray(tape.q0),
            jnp.asarray(tape.q1), jnp.asarray(tape.angles))
    sel = jnp.asarray(tape.trainable)
    bl = sweeps.default_block_len(tape.padded_length)
    stop = jnp.asarray(1e-5, jnp.float32)
    tol = jnp.asarray(1e-5, jnp.float32)

    out_auto = sweeps.sweep_until_converged(
        engine, bl, True, 8, prefix, ref, args[0], args[1], args[2],
        args[3], sel, stop, tol)

    # the state the caller's cache would hold: prefix + tape at input angles
    init_state = sv_core.apply_tape(prefix, *args)
    out_cached = sweeps.sweep_until_converged(
        engine, bl, True, 8, prefix, ref, args[0], args[1], args[2],
        args[3], sel, stop, tol, init_state)

    for a, b in zip(out_auto[:5], out_cached[:5]):
        assert np.allclose(np.asarray(a), np.asarray(b), atol=1e-7)
    assert np.allclose(np.asarray(out_auto[5].re), np.asarray(out_cached[5].re),
                       atol=1e-6)
    assert np.allclose(np.asarray(out_auto[5].im), np.asarray(out_cached[5].im),
                       atol=1e-6)


class TestZigzag:
    def _setup(self, n=4, depth=12, seed=7):
        import jax.numpy as jnp
        from adaptaqc_tpu.backends import sv_core
        from adaptaqc_tpu.optim import sweeps
        rng = np.random.default_rng(seed)
        qc = random_circuit(n, depth, rng)
        tape = compile_tape(qc)
        engine = sv_core.sweep_engine()
        prefix = sv_core.zero_state(n)
        ref = sv_core.zero_state(n)
        xs = (jnp.asarray(tape.kinds), jnp.asarray(tape.q0),
              jnp.asarray(tape.q1), jnp.asarray(tape.angles),
              jnp.asarray(tape.trainable))
        return sweeps, sv_core, engine, prefix, ref, tape, xs

    def test_first_forward_cycle_matches_standard_sweep(self):
        """A zigzag forward cycle fed with an R-buffer built at the input
        angles must produce exactly the standard sweep's updates."""
        import jax
        import jax.numpy as jnp
        sweeps, sv_core, engine, prefix, ref, tape, xs = self._setup()
        kinds, q0, q1, angles, sel = xs

        out_std = sweeps.sweep(engine, tape.padded_length, True, prefix, ref,
                               kinds, q0, q1, angles, sel)

        flip = lambda t: jax.tree.map(lambda v: jnp.flip(v, 0), t)

        def back(s, x):
            k, a, b, th, _ = x
            return engine.apply_adjoint(s, k, a, b, th), s

        _, r_rev = jax.lax.scan(back, ref, flip((kinds, q0, q1, angles, sel)))
        r_buf = flip(r_rev)
        nk, na, ov2, l_final, evals, _ = sweeps._zz_forward(
            engine, True, prefix, ref, (kinds, q0, q1, angles, sel), r_buf)

        assert np.array_equal(np.asarray(nk), np.asarray(out_std[0]))
        assert np.allclose(np.asarray(na), np.asarray(out_std[1]), atol=1e-7)
        assert float(ov2) == pytest.approx(float(out_std[5]), abs=1e-6)
        assert int(evals) == int(out_std[4])

    def test_zigzag_converges_and_returns_exact_state(self):
        import jax.numpy as jnp
        sweeps, sv_core, engine, prefix, ref, tape, xs = self._setup()
        kinds, q0, q1, angles, sel = xs
        cost0 = 1.0 - float(engine.overlap(
            ref, sv_core.apply_tape(prefix, kinds, q0, q1, angles)).abs2())
        (nk, na, cost, cycles, evals, state,
         c0_dev) = sweeps.sweep_zigzag_until_converged(
            engine, True, 30, prefix, ref, kinds, q0, q1, angles, sel,
            jnp.asarray(1e-5, jnp.float32), jnp.asarray(1e-5, jnp.float32))
        # coordinate descent never increases the cost (0.5 here is a genuine
        # rotoselect fixed point of this random circuit — the standard sweep
        # lands on exactly the same one)
        assert float(cost) <= cost0 + 1e-9
        # the returned state is exactly prefix+tape at the returned angles
        fresh = sv_core.apply_tape(prefix, nk, q0, q1, na)
        assert np.allclose(np.asarray(state.re), np.asarray(fresh.re),
                           atol=1e-6)
        assert np.allclose(np.asarray(state.im), np.asarray(fresh.im),
                           atol=1e-6)
        # cost matches the returned state's overlap
        ov2 = float(engine.overlap(ref, state).abs2())
        assert float(cost) == pytest.approx(1.0 - ov2, abs=1e-6)

    @pytest.mark.parametrize("backend_kind", ["sv", "mps"])
    def test_compile_with_zigzag_converges(self, backend_kind, monkeypatch):
        from adaptaqc_tpu import AdaptCompiler, MPSBackend, SVBackend
        monkeypatch.setenv("ADAPTAQC_ZIGZAG", "1")
        rng = np.random.default_rng(21)
        qc = random_circuit(3, 10, rng)
        backend = SVBackend() if backend_kind == "sv" else MPSBackend(max_chi=8)
        compiler = AdaptCompiler(qc, backend=backend)
        assert compiler.minimizer.zigzag
        result = compiler.compile()
        assert result.overlap > 0.99
        sv_t = simulate(co.make_quantum_only_circuit(qc))
        sv_s = simulate(co.make_quantum_only_circuit(result.circuit))
        assert abs(np.vdot(sv_t, sv_s)) ** 2 > 0.97


class TestSweepGuard:
    """The minimiser discards sweep results that end WORSE than their
    starting cost — numerically impossible for coordinate descent, so it
    can only be numerical or device corruption. Observed once: a buggy
    opt-in eigh impl silently destroyed 0.98-overlap warm starts across a
    batch of runs; the guard turns that into a warning + no-op layer."""

    def _compiler(self):
        qc = random_circuit(3, 8, np.random.default_rng(5))
        comp = AdaptCompiler(qc, adapt_config=AdaptConfig(max_layers=2))
        # materialise the variational window the way compile() does
        comp.global_cost_history = []
        comp.cost_evaluation_counter = 0
        comp._add_layer_structure = None
        return comp

    def test_corrupted_sweep_is_discarded(self, monkeypatch):
        import jax.numpy as jnp
        from adaptaqc_tpu.optim import sweeps
        from adaptaqc_tpu.utils import constants as vconstants

        comp = self._compiler()
        comp._add_initial_ansatz(
            co.make_quantum_only_circuit(random_circuit(
                3, 6, np.random.default_rng(9))), False)
        angles_before = [instr.params[0] for instr in comp.full_circuit.data
                         if instr.params]
        orig = sweeps.sweep_until_converged

        def corrupting(*a, **kw):
            out = orig(*a, **kw)
            # corrupted device result: garbage angles, cost far above cost0
            bad_angles = jnp.full_like(out[1], 1.234)
            return (out[0], bad_angles, jnp.asarray(0.97, jnp.float32),
                    out[3], out[4], out[5], out[6])

        monkeypatch.setattr(sweeps, "sweep_until_converged", corrupting)
        cost = comp.minimizer.minimize_cost(
            algorithm_kind=vconstants.ALG_ROTOSOLVE, tol=1e-3,
            stop_val=1e-2, indexes_to_modify=comp.variational_circuit_range())
        angles_after = [instr.params[0] for instr in comp.full_circuit.data
                        if instr.params]
        # no writeback: the input angles survive, and the returned cost is
        # the (healthy) input-angle cost, not the corrupted one
        assert angles_after == angles_before
        assert cost < 0.9
        true_cost = comp.evaluate_cost()
        assert cost == pytest.approx(true_cost, abs=1e-5)

    def test_healthy_sweep_still_writes_back(self):
        from adaptaqc_tpu.utils import constants as vconstants

        comp = self._compiler()
        comp._add_initial_ansatz(
            co.make_quantum_only_circuit(random_circuit(
                3, 6, np.random.default_rng(9))), False)
        c0 = comp.evaluate_cost()
        cost = comp.minimizer.minimize_cost(
            algorithm_kind=vconstants.ALG_ROTOSOLVE, tol=1e-6,
            stop_val=-1.0, indexes_to_modify=comp.variational_circuit_range())
        assert cost <= c0 + 1e-6
        assert cost == pytest.approx(comp.evaluate_cost(), abs=1e-5)
