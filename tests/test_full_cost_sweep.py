"""Device full-cost sweep (local / softened costs) vs the host probe loop.

The reference optimises local and softened-global costs by per-gate 3-point
probing with one full circuit re-simulation per probe
(cost_minimiser.py:267-368). sweeps.sweep_full fuses that exact probe
structure into one device program; these tests assert the device path
reproduces the host loop's angles and cost on identical compilers.
"""

import numpy as np
import pytest

from adaptaqc_tpu import AdaptCompiler, Circuit, MPSBackend, SVBackend
from adaptaqc_tpu.circuits import operations as co
from adaptaqc_tpu.utils import constants as vconstants

from test_sv_core import random_circuit


def _ry_dressed_layer():
    """CX dressed with ry rotations only: for the Z-basis local cost a
    trailing rz is cost-flat (diagonal unitaries commute with every Z_q), so
    the default rz-dressed layer has gates whose probe sinusoids are exactly
    flat and whose minimiser angle is an fp-noise tie. ry has no such flat
    direction generically."""
    qc = Circuit(2)
    qc.ry(0.0, [0, 1])
    qc.cx(0, 1)
    qc.ry(0.0, [0, 1])
    return qc  # labels are filled in by construct_layer_2q_gate


def _prepared_compiler(seed, backend, n=4, depth=20, **kwargs):
    # deep enough that one layer cannot fully converge: at the f64 cost
    # floor the per-gate sinusoids go flat and the probe outcomes become
    # fp-noise ties (host and device then legitimately pick different but
    # equally optimal axes/angles)
    rng = np.random.default_rng(seed)
    qc = random_circuit(n, depth, rng)
    comp = AdaptCompiler(qc, backend=backend,
                         custom_layer_2q_gate=_ry_dressed_layer(), **kwargs)
    # insert one dressed layer exactly as the adapt loop would
    layer_indexes = comp._add_entangling_layer(0)
    return comp, layer_indexes


def _minimize(comp, layer_indexes, rotoselect, force_host):
    if force_host:
        comp.minimizer._can_full_sweep = lambda *_a, **_k: False
        assert not comp.minimizer._can_fast_sweep()
    alg = (vconstants.ALG_ROTOSELECT if rotoselect
           else vconstants.ALG_ROTOSOLVE)
    cost = comp.minimizer.minimize_cost(
        algorithm_kind=alg, max_cycles=1, stop_val=-np.inf, tol=1e-10,
        indexes_to_modify=layer_indexes)
    angles = co.find_angles_in_circuit(comp.full_circuit,
                                       comp.variational_circuit_range())
    return cost, np.asarray(angles)


@pytest.mark.parametrize("rotoselect", [False, True])
def test_local_cost_device_matches_host_sv(rotoselect):
    ca, idx_a = _prepared_compiler(21, SVBackend(), optimise_local_cost=True)
    cb, idx_b = _prepared_compiler(21, SVBackend(), optimise_local_cost=True)
    assert idx_a == idx_b
    assert ca.minimizer._can_full_sweep(rotoselect)
    cost_dev, ang_dev = _minimize(ca, idx_a, rotoselect, force_host=False)
    cost_host, ang_host = _minimize(cb, idx_b, rotoselect, force_host=True)
    assert abs(cost_dev - cost_host) < 1e-7
    if cost_host > 1e-10:  # below the floor, tie-broken probes may differ
        np.testing.assert_allclose(ang_dev, ang_host, atol=1e-7)


@pytest.mark.parametrize("rotoselect", [False, True])
def test_local_cost_device_matches_host_mps(rotoselect):
    ca, idx_a = _prepared_compiler(22, MPSBackend(), optimise_local_cost=True)
    cb, idx_b = _prepared_compiler(22, MPSBackend(), optimise_local_cost=True)
    assert idx_a == idx_b
    cost_dev, ang_dev = _minimize(ca, idx_a, rotoselect, force_host=False)
    cost_host, ang_host = _minimize(cb, idx_b, rotoselect, force_host=True)
    assert abs(cost_dev - cost_host) < 1e-6
    if cost_host > 1e-10:
        np.testing.assert_allclose(ang_dev, ang_host, atol=1e-6)


def test_softened_cost_device_matches_host_mps():
    ca, idx_a = _prepared_compiler(23, MPSBackend(), soften_global_cost=True)
    cb, idx_b = _prepared_compiler(23, MPSBackend(), soften_global_cost=True)
    # a nonzero softening alpha requires cost history (the adapt loop fills
    # it between layers); seed both identically
    for c in (ca, cb):
        c.global_cost_history = [0.7]  # normally created by compile()
    cost_dev, ang_dev = _minimize(ca, idx_a, False, force_host=False)
    cost_host, ang_host = _minimize(cb, idx_b, False, force_host=True)
    assert abs(cost_dev - cost_host) < 1e-6
    if cost_host > 1e-10:
        np.testing.assert_allclose(ang_dev, ang_host, atol=1e-6)


def test_local_cost_compile_uses_device_path(monkeypatch):
    """End-to-end local-cost compile goes through the chunked full-cost
    device sweep (no silent host fallback) and still converges."""
    import adaptaqc_tpu.optim.sweeps as sweeps
    calls = {"n": 0}
    orig = sweeps.sweep_full_chunked_until_converged

    def counting(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(sweeps, "sweep_full_chunked_until_converged",
                        counting)
    rng = np.random.default_rng(24)
    qc = random_circuit(3, 10, rng)
    comp = AdaptCompiler(qc, optimise_local_cost=True)
    result = comp.compile()
    assert calls["n"] > 0
    assert result.overlap > 0.9


def test_chunked_full_sweep_matches_whole_cycle():
    """The host-driven chunked loop (bounded device calls instead of one
    minutes-long execution) reproduces the fused whole-cycle
    program: same angles, same cost, regardless of chunk boundaries."""
    import jax.numpy as jnp
    from adaptaqc_tpu.circuits.tape import compile_tape, select_mask
    from adaptaqc_tpu.optim import sweeps

    comp, idx = _prepared_compiler(27, MPSBackend(), optimise_local_cost=True)
    rng_range = comp.minimizer.variational_circuit_range()
    tape = compile_tape(comp.full_circuit,
                        (rng_range[0], len(comp.full_circuit.data)))
    mask = select_mask(tape, [i - rng_range[0] for i in range(*idx)])
    engine = comp.backend.sweep_engine()
    prefix = comp._prefix_state()
    ref = comp.backend.zero_ref(comp)
    kinds = jnp.asarray(tape.kinds)
    q0 = jnp.asarray(tape.q0)
    q1 = jnp.asarray(tape.q1)
    angles = jnp.asarray(tape.angles)
    weights = jnp.asarray((0.0, 1.0, 0.0), angles.dtype)

    k_w, a_w, cost_w, _state, ev_w = sweeps.sweep_full(
        engine, False, prefix, ref, kinds, q0, q1, angles,
        jnp.asarray(mask), weights)
    # call_budget=1 forces the minimum chunk (16 gates) -> many chunks
    k_c, a_c, cost_c, cycles, ev_c, _state2, cost0 = \
        sweeps.sweep_full_chunked_until_converged(
            engine, False, 1, prefix, ref, kinds, q0, q1, angles,
            jnp.asarray(mask), -np.inf, 1e-10, weights, call_budget=1)
    assert cycles == 1
    assert int(ev_w) == int(ev_c)
    np.testing.assert_array_equal(np.asarray(k_w), np.asarray(k_c))
    np.testing.assert_allclose(np.asarray(a_w), np.asarray(a_c), atol=1e-12)
    assert abs(float(cost_w) - float(cost_c)) < 1e-12


def test_hybrid_local_compile_with_global_polish():
    """Hybrid schedule: local-cost training with a clamped window plus the
    periodic global-cost consolidation pass actually runs the polish
    (phase_timings) and converges on the MPS backend."""
    from adaptaqc_tpu import AdaptConfig
    rng = np.random.default_rng(26)
    qc = random_circuit(4, 20, rng)
    comp = AdaptCompiler(
        qc, backend=MPSBackend(), optimise_local_cost=True,
        adapt_config=AdaptConfig(max_layers=40, sufficient_cost=1e-2,
                                 local_window_layers=4,
                                 global_polish_frequency=1))
    result = comp.compile()
    assert result.overlap > 0.97
    assert comp.phase_timings["global_polish"] > 0.0


def test_chunked_full_sweep_uses_cached_init_state():
    """ADVICE r4: a caller-provided init_state (the compiler's full-state
    cache) must replace the probe-free cost0 tape pass — observable because
    cost0 is then derived from the GIVEN state rather than re-simulated."""
    import jax.numpy as jnp
    from adaptaqc_tpu.circuits.tape import compile_tape, select_mask
    from adaptaqc_tpu.optim import sweeps

    comp, idx = _prepared_compiler(28, MPSBackend(), optimise_local_cost=True)
    rng_range = comp.minimizer.variational_circuit_range()
    tape = compile_tape(comp.full_circuit,
                        (rng_range[0], len(comp.full_circuit.data)))
    mask = select_mask(tape, [i - rng_range[0] for i in range(*idx)])
    engine = comp.backend.sweep_engine()
    prefix = comp._prefix_state()
    ref = comp.backend.zero_ref(comp)
    args = (jnp.asarray(tape.kinds), jnp.asarray(tape.q0),
            jnp.asarray(tape.q1), jnp.asarray(tape.angles))
    weights = jnp.asarray((0.0, 1.0, 0.0), args[3].dtype)

    *_, cost0_plain = sweeps.sweep_full_chunked_until_converged(
        engine, False, 1, prefix, ref, *args, jnp.asarray(mask),
        -np.inf, 1e-10, weights)
    # the true prefix+tape state: passing it must give the same cost0
    l0 = prefix
    for k0 in range(0, int(args[0].shape[0]), 16):
        _, _, l0, _ = sweeps.sweep_full_chunk(
            engine, False, 16, jnp.int32(k0), l0, ref, *args,
            jnp.zeros_like(jnp.asarray(mask)), weights)
    *_, cost0_cached = sweeps.sweep_full_chunked_until_converged(
        engine, False, 1, prefix, ref, *args, jnp.asarray(mask),
        -np.inf, 1e-10, weights, init_state=l0)
    assert abs(float(cost0_plain) - float(cost0_cached)) < 1e-6
    # a deliberately WRONG init_state must change cost0 — proof the cache
    # is consumed instead of re-simulated
    *_, cost0_wrong = sweeps.sweep_full_chunked_until_converged(
        engine, False, 1, prefix, ref, *args, jnp.asarray(mask),
        -np.inf, 1e-10, weights, init_state=ref)
    assert abs(float(cost0_wrong) - float(cost0_plain)) > 1e-3
