"""general_gradient pair-selection heuristic (arXiv:2503.09683 App. A).

Mirror of /root/reference/adaptaqc/utils/gradients.py: for the layer ansatz
U(theta) = prod U_k with U_k = exp(-i theta_k/2 A_k), score each candidate
pair (c, t) by the Euclidean norm of dC/dtheta at theta=0:

    g_k = -Im(<s|G_k|psi><psi|U^dag(0)|s>),   g = sqrt(sum_k deg_k g_k^2)

Device-side inversion: the reference builds one circuit per (pair, generator) and
re-simulates it in Aer (gradients.py:81-122). Here each generator and
U^dag(0) is a fixed 4x4 operator, operator-Schmidt decomposed host-side into
<=4 Kronecker terms, and ALL (pair, generator, term) overlap chains run as
one batched on-device MPS transfer contraction.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..circuits import gates as G
from ..circuits.circuit import Circuit, Instruction
from ..circuits.peephole import remove_unnecessary_2q_gates_from_circuit


# ------------------------------------------------------------- host circuits

def get_generator(ansatz: Circuit, index: int, op: str) -> Circuit:
    """Replace the rotation at `index` by its Pauli generator, drop all other
    rotations, keep cx gates, cancel adjacent cx pairs (gradients.py:173-224)."""
    supported = {"rx": "x", "ry": "y", "rz": "z"}
    if op not in supported:
        raise ValueError("op must be one of rx, ry or rz")
    generator = Circuit(2)
    for i, instr in enumerate(ansatz.data):
        if instr.name not in ("rx", "ry", "rz", "cx"):
            raise ValueError("Circuit must only contain rx, ry, rz and cx gates")
        if i == index:
            generator.data.append(Instruction(supported[op], (instr.qubits[0],)))
        if instr.name == "cx":
            generator.cx(*instr.qubits)
    remove_unnecessary_2q_gates_from_circuit(generator)
    return generator


def get_generators_and_degeneracies(ansatz: Circuit, rotoselect: bool = False,
                                    inverse: bool = False
                                    ) -> Tuple[List[Circuit], List[int]]:
    """gradients.py:127-170."""
    parameterised = ("rx", "ry", "rz")
    circuits = []
    for i, instr in enumerate(ansatz.data):
        if instr.name in parameterised:
            ops = parameterised if rotoselect else (instr.name,)
            for op in ops:
                gen = get_generator(ansatz, i, op)
                circuits.append(gen.inverse() if inverse else gen)
    distinct: List[Circuit] = []
    degeneracies: List[int] = []
    from ..circuits.operations import are_circuits_identical
    for circ in circuits:
        for j, d in enumerate(distinct):
            if are_circuits_identical(circ, d):
                degeneracies[j] += 1
                break
        else:
            distinct.append(circ)
            degeneracies.append(1)
    return distinct, degeneracies


def zero_ansatz_inverse(layer_gate: Circuit) -> Circuit:
    """U^dag(0): the layer ansatz at theta=0, inverted
    (adapt_compiler.py:216)."""
    zeroed = layer_gate.copy()
    for instr in zeroed.data:
        if instr.is_supported_1q_gate():
            instr.params = (0.0,)
    return zeroed.inverse()


def circuit_to_matrix_2q(circuit: Circuit) -> np.ndarray:
    """Dense 4x4 of a 2-qubit circuit, basis r = 2*b(q1)+b(q0)."""
    m = np.eye(4, dtype=complex)
    for instr in circuit.data:
        name = instr.name
        if len(instr.qubits) == 1:
            u = G.u1q_np(name, instr.params[0] if instr.params else 0.0)
            q = instr.qubits[0]
            full = np.kron(u, np.eye(2)) if q == 1 else np.kron(np.eye(2), u)
        else:
            u4 = G.u2q_np(name) if name != "cx" or instr.qubits == (0, 1) else None
            if name == "cx" and instr.qubits == (1, 0):
                full = np.eye(4)[[0, 1, 3, 2]]  # control q1, target q0
            elif name == "cx":
                full = G.u2q_np("cx")
            else:
                full = G.u2q_np(name)
        m = full @ m
    return m


def operator_schmidt(m: np.ndarray):
    """Decompose a 4x4 M into sum_a A_a (x) B_a with A on qubit 1, B on
    qubit 0 (r = 2*b1 + b0). Returns (A (4,2,2), B (4,2,2), n_terms)."""
    t = m.reshape(2, 2, 2, 2)            # [r1, r0, c1, c0]
    t = t.transpose(0, 2, 1, 3).reshape(4, 4)  # [(r1,c1), (r0,c0)]
    u, s, vh = np.linalg.svd(t)
    a = np.zeros((4, 2, 2), dtype=complex)
    b = np.zeros((4, 2, 2), dtype=complex)
    n_terms = 0
    for i, sv in enumerate(s):
        if sv > 1e-12:
            a[n_terms] = (np.sqrt(sv) * u[:, i]).reshape(2, 2)
            b[n_terms] = (np.sqrt(sv) * vh[i, :]).reshape(2, 2)
            n_terms += 1
    return a, b, n_terms


def prepare_gradient_ops(inverse_zero_ansatz: Circuit,
                         generator_dagger_circuits: List[Circuit]):
    """Pack U^dag(0) and the generators G_k as Schmidt-term arrays for the
    batched device contraction. The provided circuits are (G_k)^dag (the
    reference passes inverse=True); G_k matrices are their adjoints."""
    u0 = circuit_to_matrix_2q(inverse_zero_ansatz)
    ops = [operator_schmidt(u0)]
    for gen_dag in generator_dagger_circuits:
        gk = circuit_to_matrix_2q(gen_dag).conj().T
        ops.append(operator_schmidt(gk))
    a = np.stack([o[0] for o in ops])  # (K+1, 4, 2, 2) — acts on target
    b = np.stack([o[1] for o in ops])  # (K+1, 4, 2, 2) — acts on control
    return a, b


# ------------------------------------------------------------- device scoring

def general_grad_of_pairs_device(psi, starting_circuit, gradient_ops,
                                 degeneracies, coupling_map, backend, n):
    """Batched evaluation of the pair gradients (gradients.py:23-124).

    psi: engine MPS state |psi> = V^dag(theta) U |0>.
    """
    import jax.numpy as jnp
    from ..backends import mps_core
    from ..circuits.tape import compile_tape
    from ..ops import cplx

    a_np, b_np = gradient_ops
    # |s>: starting circuit state (product/zero state unless user-provided)
    s_state = backend.initial_state(Circuit(n), n)
    if starting_circuit is not None:
        tape = compile_tape(starting_circuit)
        s_state = backend.run_tape(s_state, tape)

    pairs = np.asarray(coupling_map, dtype=np.int32)
    a_ops = cplx.from_np(a_np)
    b_ops = cplx.from_np(b_np)
    # static bound on the pair span -> the env-cached scorer's middle loop
    # length (1 for linear coupling maps: no middle sites at all)
    max_dist = int(np.max(np.abs(pairs[:, 1] - pairs[:, 0])))

    # z[k, p]: k=0 -> <psi|U^dag(0)|s>; k>=1 -> <s|G_k|psi>
    z0 = mps_core.pair_op_overlaps(psi, s_state, a_ops[0:1], b_ops[0:1],
                                   jnp.asarray(pairs), max_dist)
    zk = mps_core.pair_op_overlaps(s_state, psi, a_ops[1:], b_ops[1:],
                                   jnp.asarray(pairs), max_dist)
    z0 = cplx.to_np(z0)[0]          # (P,)
    zk = cplx.to_np(zk)             # (K, P)

    degs = np.asarray(degeneracies, dtype=float)[:, None]
    gk = -np.imag(zk * z0[None, :])
    grads = np.sqrt(np.sum(degs * gk ** 2, axis=0))
    return list(grads)
