"""Center-gauge (mixed-canonical) MPS engine — the ITensor-style second
engine.

Reference parity: the reference ships an experimental alternative MPS
backend over ITensorNetworks.jl (/root/reference/adaptaqc/backends/
itensor_backend.py:17-62 + the Julia package it shells out to). Its value
is an INDEPENDENT tensor-network engine for cross-checking the primary
simulator. This module is that analogue, in JAX: a from-scratch
mixed-canonical MPS engine in the ITensor idiom — site tensors with an
explicit orthogonality center, gates applied by moving the center to the
bond and truncating with a `cutoff` — sharing no state layout, gauge
convention, or update algebra with the primary Hastings B-form engine
(`mps_core.py`):

  - mps_core: Vidal/Hastings gauge (B tensors + bond weight vectors), all
    bonds simultaneously canonical, renormalised spectra per apply.
  - here: ITensor gauge (plain site tensors, one orthogonality center),
    weights live in the center tensor, NO renormalisation per apply (norm
    decays by exactly the truncated weight, as ITensor's `apply` does).

State layout: T (n, 2, chi, chi) split-complex site tensors; sites left of
`center` are left-canonical isometries, sites right of it right-canonical.
All shapes static (chi-padded) so every program jits once per
(n, chi, tape-length) bucket; the dynamic center index is threaded through
`lax.while_loop` center moves.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..circuits import gates as G
from ..ops import cplx
from ..ops.cplx import C
from .. import config
from .sv_core import build_u4

__all__ = [
    "CMPS", "zero_cmps", "from_bform", "apply_tape", "apply_tape_adjoint",
    "move_center_to", "overlap_with_zero", "cmps_dot", "norm_sq",
    "global_cost_normalized", "z_expectations", "all_pair_rdms", "to_dense",
]


class CMPS(NamedTuple):
    t: C                    # (n, 2, chi, chi) site tensors [p, left, right]
    center: jnp.ndarray     # () int32 — orthogonality-center site
    # accumulated relative discarded Schmidt weight (same meaning as
    # MPS.trunc in mps_core; ITensor surfaces it as `maxtruncerr`)
    trunc: jnp.ndarray = 0.0

    @property
    def n(self):
        return self.t.shape[0]

    @property
    def chi(self):
        return self.t.shape[-1]


def zero_cmps(n: int, chi: int, dtype=None) -> CMPS:
    dtype = dtype or config.real_dtype()
    tre = jnp.zeros((n, 2, chi, chi), dtype).at[:, 0, 0, 0].set(1.0)
    t = C(tre, jnp.zeros((n, 2, chi, chi), dtype))
    return CMPS(t, jnp.zeros((), jnp.int32), jnp.zeros((), dtype))


def from_bform(state) -> CMPS:
    """Exact gauge conversion from the primary engine's Hastings B-form.

    A B-form state is diag(lam_0) B_0 B_1 ... B_{n-1} with every B_i
    right-canonical, so absorbing the (trivial, e_1) left boundary weight
    into site 0 IS a center-gauge state with the center at site 0."""
    lam0 = state.lam[0]
    t0 = C(state.b.re[0] * lam0[None, :, None],
           state.b.im[0] * lam0[None, :, None])
    t = C(state.b.re.at[0].set(t0.re), state.b.im.at[0].set(t0.im))
    return CMPS(t, jnp.zeros((), jnp.int32),
                jnp.asarray(state.trunc, state.lam.dtype))


# ------------------------------------------------------------- center moves

def _site(state: CMPS, k):
    chi = state.chi
    z = jnp.zeros_like(k)
    re = lax.dynamic_slice(state.t.re, (k, z, z, z), (1, 2, chi, chi))
    im = lax.dynamic_slice(state.t.im, (k, z, z, z), (1, 2, chi, chi))
    return C(re[0], im[0])


def _put_site(state: CMPS, k, tk: C) -> CMPS:
    z = jnp.zeros_like(k)
    re = lax.dynamic_update_slice(state.t.re, tk.re[None], (k, z, z, z))
    im = lax.dynamic_update_slice(state.t.im, tk.im[None], (k, z, z, z))
    return CMPS(C(re, im), state.center, state.trunc)


def _shift_right(state: CMPS) -> CMPS:
    """Move the orthogonality center one site right: split T_c into a
    left-canonical isometry (kept at c) times a weight carry that is
    multiplied into T_{c+1}. Both shift directions decompose a (2chi, chi)
    matrix so the Gram eigh stays at chi x chi."""
    c = state.center
    chi = state.chi
    tc = _site(state, c)                       # (2, chi, chi)
    m = tc.reshape(2 * chi, chi)               # rows (p, a), cols b
    u, s, vh = cplx.svd_trunc(m, chi, 0.0)     # pure gauge move: no cutoff
    new_tc = u.reshape(2, chi, chi)
    carry = C(s[:, None] * vh.re, s[:, None] * vh.im)   # (chi, chi)
    tn = _site(state, c + 1)
    new_tn = cplx.einsum("ac,pcb->pab", carry, tn)
    state = _put_site(state, c, new_tc)
    state = _put_site(state, c + 1, new_tn)
    return CMPS(state.t, c + 1, state.trunc)


def _shift_left(state: CMPS) -> CMPS:
    """Move the center one site left: T_c = carry . (right-canonical part),
    obtained from the SVD of M^H so the decomposed matrix is again
    (2chi, chi): M = Vh^H S U^H with U^H a row-isometry."""
    c = state.center
    chi = state.chi
    tc = _site(state, c)
    m = tc.transpose(1, 0, 2).reshape(chi, 2 * chi)   # rows a, cols (p, b)
    u, s, vh = cplx.svd_trunc(m.H, chi, 0.0)          # (2chi, chi) input
    new_tc = u.H.reshape(chi, 2, chi).transpose(1, 0, 2)
    carry = C(vh.H.re * s[None, :], vh.H.im * s[None, :])  # (chi, chi)
    tp = _site(state, c - 1)
    new_tp = cplx.einsum("pab,bc->pac", tp, carry)
    state = _put_site(state, c, new_tc)
    state = _put_site(state, c - 1, new_tp)
    return CMPS(state.t, c - 1, state.trunc)


def move_center_to(state: CMPS, k) -> CMPS:
    k = jnp.asarray(k, jnp.int32)
    state = lax.while_loop(lambda s: s.center < k,
                           lambda s: _shift_right(s), state)
    state = lax.while_loop(lambda s: s.center > k,
                           lambda s: _shift_left(s), state)
    return state


# ---------------------------------------------------------- gate application

def _apply_1q_at(state: CMPS, u2: C, q) -> CMPS:
    # A 1q unitary preserves both canonical conditions, so it applies at any
    # site without moving the center (ITensor's single-site `apply`).
    tq = _site(state, q)
    return _put_site(state, q, cplx.einsum("pq,qab->pab", u2, tq))


def _apply_2q_adjacent(state: CMPS, u4: C, k, cutoff) -> CMPS:
    """Gate on adjacent sites (k, k+1): move the center into the bond,
    contract the two-site tensor, apply, SVD with `cutoff`, keep the
    left factor canonical — the center lands on k+1.

    ITensor semantics (itensor_backend.py:52-58 passes chi + cutoff to the
    Julia apply): the kept spectrum is NOT renormalised; the state norm
    decays by exactly the discarded weight, which `trunc` accumulates."""
    # center must sit inside {k, k+1} for the two-site truncation to be
    # optimal (isometric environments on both sides)
    target = jnp.clip(state.center, k, k + 1)
    state = move_center_to(state, target)
    chi = state.chi
    tl = _site(state, k)        # (2, chi, chi)
    tr = _site(state, k + 1)
    theta = cplx.einsum("pac,qcb->apqb", tl, tr)     # (chi, 2, 2, chi)
    u4r = u4.reshape(2, 2, 2, 2)                     # [q, p, q', p']
    theta = cplx.einsum("qpsr,arsb->apqb", u4r, theta)
    m = theta.reshape(chi * 2, 2 * chi)              # rows (a,pl), cols (pr,b)
    eff_cutoff = max(float(cutoff),
                     0.1 * config.lambda_eps(state.t.re.dtype))
    u, s, vh = cplx.svd_trunc(m, chi, eff_cutoff)
    kept = jnp.sum(s * s)
    total = jnp.sum(m.abs2())
    discarded = jnp.maximum(total - kept, 0.0) / jnp.maximum(total, 1e-30)
    new_tl = u.reshape(chi, 2, chi).transpose(1, 0, 2)        # left-canonical
    sv = C(s[:, None] * vh.re, s[:, None] * vh.im)            # (chi, 2chi)
    new_tr = sv.reshape(chi, 2, chi).transpose(1, 0, 2)       # carries weight
    state = _put_site(state, k, new_tl)
    state = _put_site(state, k + 1, new_tr)
    return CMPS(state.t, jnp.asarray(k + 1, jnp.int32),
                state.trunc + discarded)


_SWAP_NP = np.eye(4)[[0, 2, 1, 3]].astype(np.float64)


def _apply_2q_routed(state: CMPS, u4: C, q0, q1, cutoff) -> CMPS:
    """2q gate on (q0 < q1) via swap routing, like the primary engine (and
    Aer internally)."""
    swap = C(jnp.asarray(_SWAP_NP, state.t.re.dtype),
             jnp.zeros((4, 4), state.t.re.dtype))

    def swap_right(k, st):
        return _apply_2q_adjacent(st, swap, k, cutoff)

    state = lax.fori_loop(q0, q1 - 1, swap_right, state)
    state = _apply_2q_adjacent(state, u4, q1 - 1, cutoff)

    def swap_back(i, st):
        return _apply_2q_adjacent(st, swap, q1 - 2 - i, cutoff)

    return lax.fori_loop(0, jnp.maximum(q1 - 1 - q0, 0), swap_back, state)


def _make_apply(cutoff: float):
    def apply_gate(state: CMPS, kind, q0, q1, angle) -> CMPS:
        u4 = build_u4(kind, angle, state.t.re.dtype)
        is2q = ((kind == G.CX) | (kind == G.CZ) | (kind == G.SWAP)
                | (kind >= G.N_KINDS))

        def two_q():
            return _apply_2q_routed(state, u4, q0, q1, cutoff)

        def one_q():
            return _apply_1q_at(state, u4[:2, :2], q0)

        return lax.cond(is2q, two_q, one_q)

    def apply_adj(state: CMPS, kind, q0, q1, angle) -> CMPS:
        u4 = build_u4(kind, angle, state.t.re.dtype).H
        is2q = ((kind == G.CX) | (kind == G.CZ) | (kind == G.SWAP)
                | (kind >= G.N_KINDS))

        def two_q():
            return _apply_2q_routed(state, u4, q0, q1, cutoff)

        def one_q():
            return _apply_1q_at(state, u4[:2, :2], q0)

        return lax.cond(is2q, two_q, one_q)

    return apply_gate, apply_adj


def apply_tape(state: CMPS, kinds, q0s, q1s, angles, cutoff) -> CMPS:
    apply_gate, _ = _make_apply(cutoff)

    def body(s, x):
        return apply_gate(s, *x), None

    state, _ = lax.scan(body, state, (kinds, q0s, q1s, angles))
    return state


def apply_tape_adjoint(state: CMPS, kinds, q0s, q1s, angles, cutoff) -> CMPS:
    _, apply_adj = _make_apply(cutoff)

    def body(s, x):
        return apply_adj(s, *x), None

    rev = jax.tree.map(lambda v: jnp.flip(v, 0), (kinds, q0s, q1s, angles))
    state, _ = lax.scan(body, state, rev)
    return state


# ---------------------------------------------------------------- observables
# All gauge-agnostic (full-chain transfer contractions): they stay exact even
# if f32 rounding erodes the canonical conditions mid-tape, which is the
# whole point of a cross-check engine.

def cmps_dot(a: CMPS, b: CMPS) -> C:
    """<a|b> by a full transfer-matrix chain (no canonicality assumed)."""
    chi = a.chi
    e0 = cplx.zeros((chi, chi), a.t.re.dtype)
    e0 = C(e0.re.at[0, 0].set(1.0), e0.im)

    def site(e, x):
        ta, tb = x
        return cplx.einsum("pax,ab,pby->xy", ta.conj(), e, tb), None

    e, _ = lax.scan(site, e0, (a.t, b.t))
    return e[0, 0]


def norm_sq(state: CMPS):
    return cmps_dot(state, state).re


def overlap_with_zero(state: CMPS) -> C:
    t0 = state.t[:, 0]   # (n, chi, chi)
    chi = state.chi
    v = cplx.zeros((chi,), state.t.re.dtype)
    v = C(v.re.at[0].set(1.0), v.im)

    def site(vc, tk):
        return cplx.einsum("a,ab->b", vc, tk), None

    v, _ = lax.scan(site, v, t0)
    return v[0]


@jax.jit
def global_cost_normalized(state: CMPS):
    """1 - |<0|psi>|^2 / <psi|psi> in one device program. The reference's
    ITensor global cost is the same quantity (itensor_backend.py:34-42,
    overlap_with_zero_itensors on a normalised ITensor MPS); normalising
    explicitly also absorbs the norm decay this engine's non-renormalising
    truncation accumulates."""
    nrm2 = norm_sq(state)
    return 1.0 - overlap_with_zero(state).abs2() / jnp.maximum(nrm2, 1e-30)


@jax.jit
def z_expectations(state: CMPS):
    """<Z_q> for every site via generic left/right transfer environments
    (no gauge assumptions), per-site self-normalised like the primary
    engine's version."""
    n, chi = state.n, state.chi
    e0 = cplx.zeros((chi, chi), state.t.re.dtype)
    e0 = C(e0.re.at[0, 0].set(1.0), e0.im)

    def fwd(e, tk):
        return cplx.einsum("pax,ab,pby->xy", tk.conj(), e, tk), e

    _, lefts = lax.scan(fwd, e0, state.t)            # lefts[i]: env of sites < i

    def bwd(f, tk):
        return cplx.einsum("pxa,ab,pyb->xy", tk.conj(), f, tk), f

    flipped = jax.tree.map(lambda v: jnp.flip(v, 0), state.t)
    _, rights_rev = lax.scan(bwd, e0, flipped)
    rights = jax.tree.map(lambda v: jnp.flip(v, 0), rights_rev)

    # w[i, p] = <psi| |p><p|_i |psi>
    w = cplx.einsum("iab,ipax,ipby,ixy->ip",
                    lefts, state.t.conj(), state.t, rights).re
    return (w[:, 0] - w[:, 1]) / jnp.maximum(w[:, 0] + w[:, 1], 1e-30)


def all_pair_rdms(state: CMPS):
    """rho(i, j) for all pairs i < j, (n, n, 4, 4) with qubit i as LSB —
    same layout as the primary engine's all_pair_rdms. Moves the center to
    site 0 first so every site right of any pair closes with the identity;
    left environments come from a generic transfer scan. Each RDM is
    trace-normalised (this engine's truncation does not preserve norm)."""
    state = move_center_to(state, 0)
    n, chi = state.n, state.chi
    e0 = cplx.zeros((chi, chi), state.t.re.dtype)
    e0 = C(e0.re.at[0, 0].set(1.0), e0.im)

    def fwd(e, tk):
        return cplx.einsum("pax,ab,pby->xy", tk.conj(), e, tk), e

    _, lefts = lax.scan(fwd, e0, state.t)   # lefts[i] = env of sites < i

    ts = state.t

    def for_i(i):
        ti = ts[i]
        ei = lefts[i]   # E[c(bra), d(ket)] from the fwd scan
        # t0[p, p', a, b]: open physical legs at site i over its left env;
        # the ket tensor contracts E's ket index, the bra tensor its bra index
        t0 = cplx.einsum("cd,pda,qcb->pqab", ei, ti, ti.conj())

        def step(t, j):
            valid = (j > i) & (j < n)
            jc = jnp.clip(j, 0, n - 1)
            tj = ts[jc]
            rho = cplx.einsum("pqab,rac,sbc->rpsq", t, tj, tj.conj())
            rho = rho.reshape(4, 4)
            tr = jnp.trace(rho.re)
            rho = C(rho.re / jnp.maximum(tr, 1e-30),
                    rho.im / jnp.maximum(tr, 1e-30))
            t_new = cplx.einsum("pqab,rax,rby->pqxy", t, tj, tj.conj())
            t = cplx.where(valid, t_new, t)
            rho = cplx.where(valid, rho,
                             cplx.zeros((4, 4), state.t.re.dtype))
            return t, rho

        _, rhos = lax.scan(step, t0, jnp.arange(n))
        return rhos

    return jax.vmap(for_i)(jnp.arange(n))


# ------------------------------------------------------------- sweep engine

def local_overlap_matrix(r_state: CMPS, l_state: CMPS, q) -> C:
    """C[i,j] = <R| |i><j|_q |L> — the 2x2 local overlap the Rotosolve
    sweep needs, by generic prefix/suffix transfer environments with open
    physical legs at site q (no gauge assumptions; the two chains advance
    in one fused scan like the primary engine's version,
    mps_core.local_overlap_matrix).

    Neither CMPS is assumed normalised (this engine's truncation decays the
    norm): a global scale factor multiplies every probe value equally, so
    the sweep's closed-form |z|^2 maximisation is unaffected."""
    chi = l_state.chi
    tr_all = r_state.t
    tl_all = l_state.t
    e0 = cplx.zeros((chi, chi), l_state.t.re.dtype)
    e0 = C(e0.re.at[0, 0].set(1.0), e0.im)

    flipped = jax.tree.map(lambda v: jnp.flip(v, 0), (tr_all, tl_all))

    def step(carry, x):
        e, f = carry
        (tr, tl), (trf, tlf) = x
        e_new = cplx.einsum("pax,ab,pby->xy", tr.conj(), e, tl)
        f_new = cplx.einsum("pxa,ab,pyb->xy", trf.conj(), f, tlf)
        return (e_new, f_new), (e, f)

    _, (prefixes, suffixes_rev) = lax.scan(step, (e0, e0),
                                           ((tr_all, tl_all), flipped))
    suffixes = jax.tree.map(lambda v: jnp.flip(v, 0), suffixes_rev)
    e_q = prefixes[q]
    f_q = suffixes[q]
    return cplx.einsum("iax,ab,jby,xy->ij",
                       tr_all[q].conj(), e_q, tl_all[q], f_q)


def full_cost_terms(state: CMPS, ref: CMPS):
    """(global cost vs ref, local cost, hamming-1 sum) — the probe cost
    kernel for the full-cost device sweep. hamming-1 overlaps are not
    implemented for this engine (soften_global_cost raises in
    CenterMPSBackend.evaluate_global_cost before any sweep runs), so the
    third term is a constant 0."""
    nrm2 = jnp.maximum(norm_sq(state), 1e-30)
    g = 1.0 - cmps_dot(ref, state).abs2() / nrm2
    loc = 0.5 * (1.0 - jnp.mean(z_expectations(state)))
    return g, loc, jnp.zeros((), state.t.re.dtype)


_ENGINE_CACHE = {}


def sweep_engine(cutoff: float):
    """SweepEngine over the center-gauge engine — the device O(G)-probe
    sweep fast path the reference's ITensorBackend never had (every ITensor
    cost query shells out to a full Julia re-simulation,
    itensor_backend.py:34-42). Cached per cutoff: jit hashes the engine's
    function fields by identity (see mps_core.sweep_engine)."""
    key = float(cutoff)
    engine = _ENGINE_CACHE.get(key)
    if engine is None:
        from ..optim.sweeps import SweepEngine
        apply_gate, apply_adj = _make_apply(cutoff)
        engine = SweepEngine(
            f"center_mps[{cutoff}]", apply_gate, apply_adj,
            local_overlap_matrix, cmps_dot, None,
            cost_terms=full_cost_terms)
        _ENGINE_CACHE[key] = engine
    return engine


# -------------------------------------------------------------- host helpers

def to_dense(state: CMPS) -> np.ndarray:
    """Contract to a 2^n statevector (host, tests / small n)."""
    t = cplx.to_np(state.t)
    n, _, chi, _ = t.shape
    vec = t[0][:, 0, :]          # (2, chi) — left boundary index 0
    for i in range(1, n):
        vec = np.einsum("...a,pab->...pb", vec, t[i])
    vec = vec[..., 0]            # right boundary index 0
    # index order is (p_0, p_1, ..., p_{n-1}); qubit 0 is the LSB
    return np.transpose(vec, tuple(reversed(range(n)))).reshape(-1)
