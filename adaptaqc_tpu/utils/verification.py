"""Cross-engine verification of compiled solutions.

The reference keeps ITensorBackend around precisely so a result produced by
one tensor-network engine can be re-checked by an algorithmically independent
one (itensor_backend.py:17-62). This module is that check as a one-call
utility: re-simulate a solution circuit and its target in the CENTER-GAUGE
engine (`backends/center_mps.py` — different gauge, different update algebra,
non-renormalising truncation) and return the normalised overlap. Two
independent engines agreeing is far stronger evidence than one engine run at
doubled chi; benchmark records store it as ``independent_engine_overlap``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..backends import center_mps, mps_core
from ..circuits.operations import make_quantum_only_circuit
from ..circuits.tape import compile_tape

__all__ = ["cross_engine_overlap"]


def _simulate(circuit, chi: int, cutoff: float) -> center_mps.CMPS:
    tape = compile_tape(make_quantum_only_circuit(circuit))
    fn = jax.jit(lambda s, k, a, b, th: center_mps.apply_tape(
        s, k, a, b, th, cutoff))
    return fn(center_mps.zero_cmps(circuit.num_qubits, chi),
              jnp.asarray(tape.kinds), jnp.asarray(tape.q0),
              jnp.asarray(tape.q1), jnp.asarray(tape.angles))


def cross_engine_overlap(target, circuit, chi: int = 64,
                         cutoff: float = 1e-14) -> float:
    """|<target|circuit|0>|^2, both sides re-simulated in the center-gauge
    engine at bond dimension ``chi``, normalised by both norms (every
    deliverable-side overlap divides by the state norms — f32 chains drift
    in scale, docs/design_notes.md).

    ``target`` may be a gate circuit, an engine MPS (``mps_core.MPS``), or a
    qiskit-format MPS tuple; ``circuit`` is the solution gate circuit.
    """
    if isinstance(target, mps_core.MPS):
        tgt = center_mps.from_bform(mps_core.regauge(target, chi))
    elif mps_core.check_mps(target):
        tgt = center_mps.from_bform(mps_core.from_qiskit_mps(target, chi))
    else:
        tgt = _simulate(target, chi, cutoff)
    sol = _simulate(circuit, chi, cutoff)
    nrm2 = float(center_mps.norm_sq(sol))
    tnrm2 = float(center_mps.norm_sq(tgt))
    return float(center_mps.cmps_dot(tgt, sol).abs2()
                 / max(nrm2 * tnrm2, 1e-30))
