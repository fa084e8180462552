"""Statevector engine: pure JAX functions over a split-complex (2**n,) state.

Accelerator-native replacement for the Aer statevector simulator used by the
reference's AerSVBackend (/root/reference/adaptaqc/backends/aer_sv_backend.py).
The state is a cplx.C pair of real arrays (ops/cplx.py). Gate application
works with *traced* qubit indices (gather-based), so a single `lax.scan` over
a tape executes any circuit without recompilation and the state lives on
device for the whole compile.

Convention: little-endian (qubit 0 = least-significant bit of the basis
index), amplitude of |0...0> is state[0] — matching qiskit, so the global
cost is 1 - |state[0]|^2 (aer_sv_backend.py:28-30).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

import numpy as np

from ..circuits import gates as G
from ..circuits.tape import U4_TABLE
from ..ops import cplx
from ..ops.cplx import C
from .. import config


def zero_state(n: int, dtype=None):
    dtype = dtype or config.real_dtype()
    re = jnp.zeros(2 ** n, dtype).at[0].set(1.0)
    return C(re, jnp.zeros(2 ** n, dtype))


def state_from_vector(vec, dtype=None):
    dtype = dtype or config.real_dtype()
    v = np.asarray(vec)
    v = v / np.linalg.norm(v)
    return cplx.from_np(v, dtype)


def build_u4(kind, angle, dtype) -> C:
    """4x4 unitary (cplx.C) for a tape entry, r = 2*b(q1)+b(q0). Incl. CXR."""
    fixed_re = jnp.asarray(U4_TABLE.real, dtype)[kind]
    fixed_im = jnp.asarray(U4_TABLE.imag, dtype)[kind]
    is_rot = (kind >= G.RX) & (kind <= G.RZ)

    def rot_case():
        u2 = G.rotation_u2_c(jnp.clip(kind, G.RX, G.RZ), angle, dtype)
        eye = jnp.eye(2, dtype=dtype)
        return jnp.kron(eye, u2.re), jnp.kron(eye, u2.im)

    re, im = lax.cond(is_rot, rot_case, lambda: (fixed_re, fixed_im))
    return C(re, im)


def apply_u4(state: C, u4: C, q0, q1) -> C:
    """Apply a 4x4 unitary on (traced) qubits q0, q1 to a flat state."""
    nidx = state.re.shape[0]
    idx = jnp.arange(nidx, dtype=jnp.int32)
    m0 = jnp.left_shift(jnp.int32(1), q0)
    m1 = jnp.left_shift(jnp.int32(1), q1)
    b0 = (idx & m0) != 0
    b1 = (idx & m1) != 0
    r = 2 * b1.astype(jnp.int32) + b0.astype(jnp.int32)
    base = idx & ~(m0 | m1)
    out_re = jnp.zeros_like(state.re)
    out_im = jnp.zeros_like(state.im)
    for c in range(4):
        src = base | (m0 * (c & 1)) | (m1 * ((c >> 1) & 1))
        ur = u4.re[r, c]
        ui = u4.im[r, c]
        sr = state.re[src]
        si = state.im[src]
        out_re = out_re + ur * sr - ui * si
        out_im = out_im + ur * si + ui * sr
    return C(out_re, out_im)


def apply_gate(state: C, kind, q0, q1, angle) -> C:
    u4 = build_u4(kind, angle, state.dtype)
    return apply_u4(state, u4, q0, q1)


def apply_gate_adjoint(state: C, kind, q0, q1, angle) -> C:
    u4 = build_u4(kind, angle, state.dtype)
    return apply_u4(state, u4.H, q0, q1)


def apply_tape(state: C, kinds, q0s, q1s, angles) -> C:
    def body(s, x):
        k, a, b, th = x
        return apply_gate(s, k, a, b, th), None

    state, _ = lax.scan(body, state, (kinds, q0s, q1s, angles))
    return state


def apply_tape_adjoint(state: C, kinds, q0s, q1s, angles) -> C:
    """Apply the adjoint of the tape (reverse order, daggered gates)."""
    def body(s, x):
        k, a, b, th = x
        return apply_gate_adjoint(s, k, a, b, th), None

    rev = tuple(jnp.flip(x, 0) for x in (kinds, q0s, q1s, angles))
    state, _ = lax.scan(body, state, rev)
    return state


def overlap(a: C, b: C) -> C:
    """<a|b>."""
    return cplx.vdot(a, b)


def global_cost(state: C):
    return 1.0 - (state.re[0] ** 2 + state.im[0] ** 2)


def z_expectations(state: C, n: int):
    """<Z_i> for all qubits, one pass (aer_sv_backend.py:49-59)."""
    probs = state.abs2()
    idx = jnp.arange(probs.shape[0], dtype=jnp.int32)

    def one(q):
        bit = (idx >> q) & 1
        signs = 1.0 - 2.0 * bit.astype(probs.dtype)
        return jnp.sum(signs * probs)

    return jax.vmap(one)(jnp.arange(n, dtype=jnp.int32))


def full_cost_terms(state: C, ref: C):
    """(global cost vs ref, local cost, hamming-1 overlap sum) of one state —
    the probe cost kernel for the full-cost device sweep. Semantics mirror
    the host backend layer exactly: global 1 - |<ref|psi>|^2
    (aer_sv_backend.py:28-36), local 0.5(1 - mean <Z_q>) (:38-47), hamming-1
    sum of |<e_i|psi>|^2 (aer_mps_backend.py:88-93)."""
    n = int(np.log2(state.re.shape[0]))
    g = 1.0 - cplx.vdot(ref, state).abs2()
    loc = 0.5 * (1.0 - jnp.mean(z_expectations(state, n)))
    probs = state.abs2()
    h1 = jnp.sum(probs[jnp.asarray(2 ** np.arange(n), jnp.int32)])
    return g, loc, h1


def local_overlap_matrix(r_state: C, l_state: C, q) -> C:
    """C[i, j] = <R| (|i><j| on qubit q) |L> — the 2x2 local overlap matrix.

    All Rotosolve probe costs for a 1q gate U on qubit q follow from
    z(U) = sum_ij U[i,j] C[i,j]; cost(theta) = 1 - |z|^2. This turns the
    reference's 3 full re-simulations per gate
    (cost_minimiser.py:344-368) into one O(2^n) contraction.
    """
    idx = jnp.arange(l_state.re.shape[0], dtype=jnp.int32)
    m = jnp.left_shift(jnp.int32(1), q)
    w = ((idx & m) == 0).astype(l_state.dtype)
    partner = idx ^ m

    def dot(weight, rr, ri, lr, li):
        # sum weight * conj(r) * l
        re = jnp.sum(weight * (rr * lr + ri * li))
        im = jnp.sum(weight * (rr * li - ri * lr))
        return re, im

    lr, li = l_state.re, l_state.im
    lpr, lpi = lr[partner], li[partner]
    rr, ri = r_state.re, r_state.im
    c00 = dot(w, rr, ri, lr, li)
    c01 = dot(w, rr, ri, lpr, lpi)
    c10 = dot(1 - w, rr, ri, lpr, lpi)
    c11 = dot(1 - w, rr, ri, lr, li)
    re = jnp.stack([jnp.stack([c00[0], c01[0]]), jnp.stack([c10[0], c11[0]])])
    im = jnp.stack([jnp.stack([c00[1], c01[1]]), jnp.stack([c10[1], c11[1]])])
    return C(re, im)


def rdm2(state: C, qa, qb) -> C:
    """2-qubit reduced density matrix over (traced) qubits qa < qb.

    Basis index r = 2*b(qb) + b(qa) — matches qiskit partial_trace with the
    smaller qubit index as the LSB (entanglement_measures.py:325-340)."""
    idx = jnp.arange(state.re.shape[0], dtype=jnp.int32)
    ma = jnp.left_shift(jnp.int32(1), qa)
    mb = jnp.left_shift(jnp.int32(1), qb)
    w = (((idx & ma) == 0) & ((idx & mb) == 0)).astype(state.dtype)
    res, ims = [], []
    for c in range(4):
        src = idx | (ma * (c & 1)) | (mb * ((c >> 1) & 1))
        res.append(w * state.re[src])
        ims.append(w * state.im[src])
    s = C(jnp.stack(res), jnp.stack(ims))  # (4, 2^n) grouped amplitudes
    return s @ s.H


def all_pair_rdms(state: C, pairs):
    """(P, 4, 4) RDMs for a static integer array of qubit pairs."""
    return jax.vmap(lambda p: rdm2(state, p[0], p[1]))(pairs)


def probabilities(state: C):
    return state.abs2()


# ------------------------------------------------------------------ jit cache

@functools.lru_cache(maxsize=None)
def jitted_run(n: int):
    """prefix state + tape -> (final state, global cost)."""
    @jax.jit
    def run(prefix, kinds, q0s, q1s, angles):
        s = apply_tape(prefix, kinds, q0s, q1s, angles)
        return s, global_cost(s)

    return run


_ENGINE = None


def sweep_engine() -> "SweepEngine":
    """Cached singleton — fresh closures would retrace the jitted sweep."""
    global _ENGINE
    if _ENGINE is None:
        from ..optim.sweeps import SweepEngine
        _ENGINE = SweepEngine("sv", apply_gate, apply_gate_adjoint,
                              local_overlap_matrix, overlap,
                              cost_terms=full_cost_terms)
    return _ENGINE
