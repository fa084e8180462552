"""ctypes bindings for the native circuit-runtime kernels (native/circkit.cpp).

Builds libcirckit from the committed source on first use and exposes the
peephole simplifier and depth kernels over flat gate arrays. The library's
file name carries a hash of the source, so a library built from other
sources (or copied in from elsewhere) is never loaded. Falls back cleanly
when the toolchain or library is unavailable (or ADAPTAQC_NO_NATIVE is set),
or when a circuit contains constructs outside the flat-gate ABI
(parameterised labels, measures, state-injection instructions).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from typing import Optional

import numpy as np

from ..circuits import gates as G
from ..circuits.circuit import Circuit, Instruction

logger = logging.getLogger(__name__)

_LIB: Optional[ctypes.CDLL] = None
_LIB_TRIED = False

_NATIVE_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "native"))


def library_path() -> str:
    """Where the library built from the current circkit.cpp lives."""
    with open(os.path.join(_NATIVE_DIR, "circkit.cpp"), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_NATIVE_DIR, "build", f"libcirckit-{digest}.so")


def _build(path: str) -> None:
    """make into a private temp name, then rename: concurrent first uses
    (test workers) never load a half-written library."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    subprocess.run(["make", "-C", _NATIVE_DIR, f"OUT={tmp}"],
                   check=True, capture_output=True, timeout=120)
    os.replace(tmp, path)


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    if os.environ.get("ADAPTAQC_NO_NATIVE"):
        return None
    try:
        path = library_path()
        if not os.path.exists(path):
            _build(path)
    except (OSError, subprocess.SubprocessError) as e:
        # no source, no toolchain or a read-only install
        logger.debug(f"native circkit build unavailable: {e}")
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.ck_peephole.restype = ctypes.c_int
        lib.ck_multi_qubit_gate_depth.restype = ctypes.c_int
        _LIB = lib
    except OSError as e:
        logger.debug(f"native circkit load failed: {e}")
    return _LIB


def available() -> bool:
    return _load() is not None


def _circuit_to_arrays(circuit: Circuit, gate_range):
    lo, hi = gate_range
    n = hi - lo
    kinds = np.zeros(n, np.int32)
    q0 = np.zeros(n, np.int32)
    q1 = np.full(n, -1, np.int32)
    angles = np.zeros(n, np.float64)
    flags = np.zeros(n, np.uint8)
    from ..circuits.tape import CXR
    for i in range(n):
        instr = circuit.data[lo + i]
        if instr.clbits or instr.name not in G.NAME_TO_KIND:
            return None
        if instr.label is not None and ("#" in instr.label or "@" in instr.label):
            return None
        kind = G.NAME_TO_KIND[instr.name]
        if len(instr.qubits) == 2:
            a, b = instr.qubits
            if instr.name == "cx" and a > b:
                kind, a, b = CXR, b, a
            elif a > b:
                a, b = b, a
            kinds[i], q0[i], q1[i] = kind, a, b
        else:
            kinds[i], q0[i] = kind, instr.qubits[0]
            angles[i] = instr.params[0] if instr.params else 0.0
            if instr.is_supported_1q_gate():
                flags[i] = 1
    return kinds, q0, q1, angles, flags


def _arrays_to_instructions(kinds, q0, q1, angles, flags, count):
    out = []
    from ..circuits.tape import CXR
    for i in range(count):
        k = int(kinds[i])
        if k == CXR:
            out.append(Instruction("cx", (int(q1[i]), int(q0[i]))))
        elif int(q1[i]) >= 0:
            out.append(Instruction(G.KIND_NAMES[k], (int(q0[i]), int(q1[i]))))
        else:
            name = G.KIND_NAMES[k]
            label = name if (flags[i] & 1) else None
            params = (float(angles[i]),) if k in G.ROTATION_KINDS else ()
            out.append(Instruction(name, (int(q0[i]),), params, label=label))
    return out


def peephole(circuit: Circuit, remove_zero_gates=True, remove_small_gates=False,
             gate_range=None, min_rotation_angle=1e-3) -> bool:
    """Native fixpoint peephole. Returns True if applied (circuit mutated),
    False if the caller must use the Python fallback."""
    lib = _load()
    if lib is None:
        return False
    if gate_range is None:
        gate_range = (0, len(circuit.data))
    arrays = _circuit_to_arrays(circuit, gate_range)
    if arrays is None:
        return False
    kinds, q0, q1, angles, flags = arrays
    new_count = lib.ck_peephole(
        ctypes.c_int(len(kinds)),
        kinds.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        q0.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        q1.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        angles.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        flags.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int(0), ctypes.c_int(-1),
        ctypes.c_int(1 if remove_zero_gates else 0),
        ctypes.c_int(1 if remove_small_gates else 0),
        ctypes.c_double(min_rotation_angle))
    new_instrs = _arrays_to_instructions(kinds, q0, q1, angles, flags, new_count)
    circuit.data[gate_range[0]:gate_range[1]] = new_instrs
    return True


def multi_qubit_gate_depth(circuit: Circuit) -> Optional[int]:
    lib = _load()
    if lib is None:
        return None
    arrays = _circuit_to_arrays(circuit, (0, len(circuit.data)))
    if arrays is None:
        return None
    kinds, q0, q1, angles, flags = arrays
    return int(lib.ck_multi_qubit_gate_depth(
        ctypes.c_int(len(kinds)),
        q0.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        q1.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int(circuit.num_qubits)))
