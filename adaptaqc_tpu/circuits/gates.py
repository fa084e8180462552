"""Gate library: integer gate kinds + matrix builders (host numpy and device jnp).

This replaces the reference's reliance on qiskit gate objects
(/root/reference/adaptaqc/utils/circuit_operations/circuit_operations_basic.py:20-48)
with a flat, array-friendly representation designed for XLA: every gate in a
compiled "tape" is (kind, q0, q1, angle) and the device builds its 4x4 unitary
with a single `lax.switch`, so one compiled program executes any circuit.

Conventions (matching qiskit little-endian):
 - 1-qubit gates act on q0; their 4x4 embedding is kron(I2, U) with the 2-qubit
   basis index r = 2*b(q1) + b(q0).
 - CX has control q0, target q1.
 - RX(t) = [[cos t/2, -i sin t/2], [-i sin t/2, cos t/2]], RY, RZ standard.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax import lax

# Gate kind ids. NOP pads tapes to bucketed lengths.
NOP = 0
RX = 1
RY = 2
RZ = 3
CX = 4
CZ = 5
H = 6
X = 7
Y = 8
Z = 9
S = 10
SDG = 11
T = 12
TDG = 13
SWAP = 14

N_KINDS = 15

ROTATION_KINDS = (RX, RY, RZ)
TWO_QUBIT_KINDS = (CX, CZ, SWAP)

KIND_NAMES = {
    NOP: "nop", RX: "rx", RY: "ry", RZ: "rz", CX: "cx", CZ: "cz", H: "h",
    X: "x", Y: "y", Z: "z", S: "s", SDG: "sdg", T: "t", TDG: "tdg",
    SWAP: "swap",
}
NAME_TO_KIND = {v: k for k, v in KIND_NAMES.items()}

AXIS_TO_KIND = {"rx": RX, "ry": RY, "rz": RZ}
KIND_TO_AXIS = {RX: "rx", RY: "ry", RZ: "rz"}


# ---------------------------------------------------------------- host (numpy)

def u1q_np(name: str, angle: float = 0.0) -> np.ndarray:
    """2x2 matrix of a 1-qubit gate (host side, complex128)."""
    c, s = np.cos(angle / 2), np.sin(angle / 2)
    if name == "rx":
        return np.array([[c, -1j * s], [-1j * s, c]])
    if name == "ry":
        return np.array([[c, -s], [s, c]], dtype=complex)
    if name == "rz":
        return np.array([[np.exp(-1j * angle / 2), 0], [0, np.exp(1j * angle / 2)]])
    if name == "h":
        return np.array([[1, 1], [1, -1]], dtype=complex) / np.sqrt(2)
    if name == "x":
        return np.array([[0, 1], [1, 0]], dtype=complex)
    if name == "y":
        return np.array([[0, -1j], [1j, 0]])
    if name == "z":
        return np.array([[1, 0], [0, -1]], dtype=complex)
    if name == "s":
        return np.array([[1, 0], [0, 1j]])
    if name == "sdg":
        return np.array([[1, 0], [0, -1j]])
    if name == "t":
        return np.array([[1, 0], [0, np.exp(1j * np.pi / 4)]])
    if name == "tdg":
        return np.array([[1, 0], [0, np.exp(-1j * np.pi / 4)]])
    if name == "id":
        return np.eye(2, dtype=complex)
    raise ValueError(f"Unsupported 1q gate {name}")


def u2q_np(name: str) -> np.ndarray:
    """4x4 matrix of a 2-qubit gate with basis index r = 2*b(q1) + b(q0)."""
    if name == "cx":
        # control = q0 (LSB), target = q1
        m = np.eye(4, dtype=complex)
        m[[1, 3]] = m[[3, 1]]
        return m
    if name == "cz":
        return np.diag([1, 1, 1, -1]).astype(complex)
    if name == "swap":
        m = np.eye(4, dtype=complex)
        m[[1, 2]] = m[[2, 1]]
        return m
    raise ValueError(f"Unsupported 2q gate {name}")


# Fixed-gate 4x4 table indexed by kind (angle-independent entries; rotations
# filled with identity and overridden on device).
def _fixed_u4_table() -> np.ndarray:
    table = np.zeros((N_KINDS, 4, 4), dtype=complex)
    eye = np.eye(2, dtype=complex)
    for kind, name in KIND_NAMES.items():
        if kind in (RX, RY, RZ, NOP):
            table[kind] = np.eye(4)
        elif kind in TWO_QUBIT_KINDS:
            table[kind] = u2q_np(name)
        else:
            table[kind] = np.kron(eye, u1q_np(name))
    return table


FIXED_U4_TABLE = _fixed_u4_table()


# --------------------------------------------------------------- device (jnp)
# All device math is split-complex (re/im real pairs, ops/cplx.py).

def rotation_u2_c(kind, angle, dtype):
    """2x2 rotation matrix as cplx.C; kind one of RX/RY/RZ (traced)."""
    from ..ops.cplx import C
    c = jnp.cos(angle / 2).astype(dtype)
    s = jnp.sin(angle / 2).astype(dtype)
    z = jnp.zeros((), dtype)

    def mk(re, im):
        return (jnp.stack([jnp.stack(re[0]), jnp.stack(re[1])]),
                jnp.stack([jnp.stack(im[0]), jnp.stack(im[1])]))

    rx = mk([[c, z], [z, c]], [[z, -s], [-s, z]])
    ry = mk([[c, -s], [s, c]], [[z, z], [z, z]])
    rz = mk([[c, z], [z, c]], [[-s, z], [z, s]])
    re, im = lax.switch(kind - RX, [lambda: rx, lambda: ry, lambda: rz])
    return C(re, im)


# Pauli matrices, used by Rotoselect axis scoring.
PAULIS_NP = np.stack([
    u1q_np("x"), u1q_np("y"), u1q_np("z")
])
