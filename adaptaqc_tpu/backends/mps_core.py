"""MPS engine: Vidal-form matrix product state simulation in pure JAX.

Device-native replacement for the Aer MPS simulator +
aqc_research.mps_operations stack the reference builds on
(/root/reference/adaptaqc/backends/aer_mps_backend.py, SURVEY.md section
2.6). Design points:

 - Fixed, padded bond dimension: the per-site tensor stack is a
   split-complex (n, 2, chi, chi) array of B-form tensors (Hastings update,
   see _apply_2q_adjacent), lam is (n+1, chi) real with boundary
   lam[0] = lam[n] = e0. Static shapes keep one compiled program per
   (n, chi) — no recompiles as the circuit grows, unlike dynamic-chi CPU
   codes.
 - Gate application on *traced* site indices via dynamic_slice, so a
   `lax.scan` over a tape executes any circuit. Non-adjacent 2q gates are
   routed with swap networks exactly like Aer does internally.
 - Bond truncation via split-complex SVD (ops/cplx.py): singular values below
   `threshold` are zeroed and the spectrum is renormalised, matching
   mps_sim_with_args(truncation_threshold, max_chi) semantics
   (aer_mps_backend.py:27-42).

The state is the convention ψ = λ0 Γ0 λ1 Γ1 ... Γ_{n-1} λn with B-form
tensors B_i[p] = Γ_i[p] diag(λ_{i+1}); amplitude(bits) = (Π B_i[b_i])[0,0].
Little-endian qubit order matches the statevector engine.
"""

from __future__ import annotations

import functools
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


class MPS(NamedTuple):
    # Right-weighted B-form site tensors B_i[p] = Gamma_i[p] diag(lam_{i+1})
    # (Hastings, arXiv:0903.3253): storing B instead of Vidal's Gamma lets
    # the 2q update avoid dividing by bond weights entirely, which is what
    # keeps f32 evolution norm-stable under heavy truncation.
    b: C              # (n, 2, chi, chi)
    lam: jnp.ndarray  # (n+1, chi) real
    # accumulated relative discarded Schmidt weight: every 2q apply adds
    # (||theta||_F^2 - sum kept s^2) / ||theta||_F^2. Nonzero means the
    # chi cap or the truncation threshold is actively binding (Aer surfaces
    # the same signal via mps_log_data, aer_mps_backend.py:27-42).
    trunc: jnp.ndarray = 0.0

    @property
    def n(self):
        return self.b.shape[0]

    @property
    def chi(self):
        return self.b.shape[-1]


def zero_mps(n: int, chi: int, dtype=None) -> MPS:
    dtype = dtype or config.real_dtype()
    bre = jnp.zeros((n, 2, chi, chi), dtype).at[:, 0, 0, 0].set(1.0)
    b = C(bre, jnp.zeros((n, 2, chi, chi), dtype))
    lam = jnp.zeros((n + 1, chi), dtype).at[:, 0].set(1.0)
    return MPS(b, lam, jnp.zeros((), dtype))


def product_mps(amps: np.ndarray, chi: int, dtype=None) -> MPS:
    """chi=1 product state from per-site (n, 2) complex amplitudes."""
    dtype = dtype or config.real_dtype()
    n = amps.shape[0]
    st = zero_mps(n, chi, dtype)
    bre = st.b.re.at[:, 0, 0, 0].set(jnp.asarray(amps[:, 0].real, dtype))
    bre = bre.at[:, 1, 0, 0].set(jnp.asarray(amps[:, 1].real, dtype))
    bim = st.b.im.at[:, 0, 0, 0].set(jnp.asarray(amps[:, 0].imag, dtype))
    bim = bim.at[:, 1, 0, 0].set(jnp.asarray(amps[:, 1].imag, dtype))
    return MPS(C(bre, bim), st.lam, st.trunc)


def _pinv(v, eps=None):
    eps = eps or config.lambda_eps(v.dtype)
    return jnp.where(v > eps, 1.0 / jnp.maximum(v, eps), 0.0)


def b_tensors(state: MPS) -> C:
    """The (natively stored) B-form tensors B_i[p] = Gamma_i[p]
    diag(lam_{i+1}): (n, 2, chi, chi)."""
    return state.b


# ------------------------------------------------------------ gate application

def _apply_1q_at(state: MPS, u2: C, q) -> MPS:
    chi = state.chi
    z = jnp.zeros_like(q)
    site_re = lax.dynamic_slice(state.b.re, (q, z, z, z), (1, 2, chi, chi))
    site_im = lax.dynamic_slice(state.b.im, (q, z, z, z), (1, 2, chi, chi))
    site = C(site_re[0], site_im[0])  # (2, chi, chi)
    new = cplx.einsum("pq,qab->pab", u2, site)
    bre = lax.dynamic_update_slice(state.b.re, new.re[None], (q, z, z, z))
    bim = lax.dynamic_update_slice(state.b.im, new.im[None], (q, z, z, z))
    return MPS(C(bre, bim), state.lam, state.trunc)


def _apply_2q_adjacent(state: MPS, u4: C, k, threshold) -> MPS:
    """Apply 4x4 u4 (r = 2*p_right + p_left) on adjacent sites (k, k+1).

    Hastings-style update (arXiv:0903.3253): both new site tensors are
    produced WITHOUT dividing by any bond weight —
      theta~ = B_l B_r                (no left lambda)
      theta  = diag(lam_l) theta~ ; SVD theta = U S V^H
      B_r'   = V^H
      B_l'   = theta~ V / ||S||      (= inv(lam_l) U S / ||S|| exactly)
    Inverting post-truncation lambdas is what makes plain Vidal TEBD drift
    off norm in f32; this form stays norm-stable."""
    chi = state.chi
    z = jnp.zeros_like(k)
    bre = lax.dynamic_slice(state.b.re, (k, z, z, z), (2, 2, chi, chi))
    bim = lax.dynamic_slice(state.b.im, (k, z, z, z), (2, 2, chi, chi))
    bl = C(bre[0], bim[0])  # (2, chi, chi) site k
    br = C(bre[1], bim[1])  # site k+1
    lam_l = lax.dynamic_slice(state.lam, (k, z), (1, chi))[0]

    theta_t = cplx.einsum("pac,qcb->apqb", bl, br)  # (chi, 2, 2, chi)
    u4r = u4.reshape(2, 2, 2, 2)  # [q, p, q', p']
    theta_t = cplx.einsum("qpsr,arsb->apqb", u4r, theta_t)
    theta = C(theta_t.re * lam_l[:, None, None, None],
              theta_t.im * lam_l[:, None, None, None])

    m = theta.reshape(chi * 2, 2 * chi)  # rows (a,pl), cols (pr,b)
    # floor the user threshold at the working precision's noise scale:
    # f32 singular values below ~1e-7 are rounding artefacts
    eff_threshold = max(float(threshold),
                        0.1 * config.lambda_eps(state.lam.dtype))
    u, s, vh = cplx.svd_trunc(m, chi, eff_threshold)
    # renormalise the kept spectrum (Aer renormalises after truncation)
    kept = jnp.sum(s * s)
    snorm = jnp.sqrt(kept)
    s_new = s / jnp.maximum(snorm, 1e-30)
    # relative Schmidt weight lost to the chi cap / threshold this apply
    total = jnp.sum(m.abs2())
    discarded = jnp.maximum(total - kept, 0.0) / jnp.maximum(total, 1e-30)

    br_new = vh.reshape(chi, 2, chi).transpose(1, 0, 2)   # (pr, c, b)
    # B_l' = theta~ V / ||S||: contract cols (pr, b) of theta~ with conj(vh)
    mt = theta_t.reshape(chi * 2, 2 * chi)
    bl_flat = mt @ vh.H                                   # (2chi, chi)
    inv_norm = 1.0 / jnp.maximum(snorm, 1e-30)
    bl_new = C(bl_flat.re.reshape(chi, 2, chi).transpose(1, 0, 2) * inv_norm,
               bl_flat.im.reshape(chi, 2, chi).transpose(1, 0, 2) * inv_norm)

    stack = cplx.stack([bl_new, br_new])   # (2, 2, chi, chi)
    bre2 = lax.dynamic_update_slice(state.b.re, stack.re, (k, z, z, z))
    bim2 = lax.dynamic_update_slice(state.b.im, stack.im, (k, z, z, z))
    lam2 = lax.dynamic_update_slice(state.lam, s_new[None], (k + 1, z))
    return MPS(C(bre2, bim2), lam2, state.trunc + discarded)


_SWAP_NP = np.eye(4)[[0, 2, 1, 3]].astype(np.float64)


def _swap_u4(dtype):
    return C(jnp.asarray(_SWAP_NP, dtype), jnp.zeros((4, 4), dtype))


def _apply_2q_routed(state: MPS, u4: C, q0, q1, threshold) -> MPS:
    """2q gate on (q0 < q1) with swap routing (Aer does the same internally)."""
    swap = _swap_u4(state.lam.dtype)

    def swap_right(k, st):
        return _apply_2q_adjacent(st, swap, k, threshold)

    state = lax.fori_loop(q0, q1 - 1, swap_right, state)
    state = _apply_2q_adjacent(state, u4, q1 - 1, threshold)

    def swap_back(m, st):
        return _apply_2q_adjacent(st, swap, q1 - 2 - m, threshold)

    state = lax.fori_loop(0, jnp.maximum(q1 - 1 - q0, 0), swap_back, state)
    return state


def make_apply(threshold: float):
    """Build (state, kind, q0, q1, angle) -> state appliers for the sweep."""
    def apply_gate(state: MPS, kind, q0, q1, angle) -> MPS:
        u4 = build_u4(kind, angle, state.lam.dtype)
        is2q = (kind == G.CX) | (kind == G.CZ) | (kind == G.SWAP) | (kind >= G.N_KINDS)

        def two_q():
            return _apply_2q_routed(state, u4, q0, q1, threshold)

        def one_q():
            return _apply_1q_at(state, u4[:2, :2], q0)

        return lax.cond(is2q, two_q, one_q)

    def apply_gate_adjoint(state: MPS, kind, q0, q1, angle) -> MPS:
        u4 = build_u4(kind, angle, state.lam.dtype)
        u4h = u4.H
        is2q = (kind == G.CX) | (kind == G.CZ) | (kind == G.SWAP) | (kind >= G.N_KINDS)

        def two_q():
            return _apply_2q_routed(state, u4h, q0, q1, threshold)

        def one_q():
            return _apply_1q_at(state, u4h[:2, :2], q0)

        return lax.cond(is2q, two_q, one_q)

    return apply_gate, apply_gate_adjoint


def apply_tape(state: MPS, kinds, q0s, q1s, angles, threshold) -> MPS:
    apply_gate, _ = make_apply(threshold)

    def body(s, x):
        k, a, b, th = x
        return apply_gate(s, k, a, b, th), None

    state, _ = lax.scan(body, state, (kinds, q0s, q1s, angles))
    return state


def apply_tape_adjoint(state: MPS, kinds, q0s, q1s, angles, threshold) -> MPS:
    """Apply the ADJOINT of a tape: gates reversed, each as its dagger.
    Used to peel a trailing gate group off a cached state (exact for 1q
    groups — single-qubit adjoints involve no bond truncation)."""
    _, apply_adj = make_apply(threshold)

    def body(s, x):
        k, a, b, th = x
        return apply_adj(s, k, a, b, th), None

    rev = jax.tree.map(lambda v: jnp.flip(v, 0), (kinds, q0s, q1s, angles))
    state, _ = lax.scan(body, state, rev)
    return state


# ---------------------------------------------------------------- observables

def mps_dot(a: MPS, b: MPS) -> C:
    """<a|b> via transfer-matrix contraction (mps_operations.mps_dot)."""
    chi = a.chi
    ba = b_tensors(a)
    bb = b_tensors(b)
    e0 = cplx.zeros((chi, chi), a.lam.dtype)
    e0 = C(e0.re.at[0, 0].set(1.0), e0.im)

    def site(e, x):
        ta, tb = x  # (2, chi, chi) each
        new = cplx.einsum("pax,ab,pby->xy", ta.conj(), e, tb)
        return new, None

    e, _ = lax.scan(site, e0, (ba, bb))
    return e[0, 0]


def overlap_with_zero(state: MPS) -> C:
    """<0...0|state> — chain of B_i[0] matrices."""
    bs = b_tensors(state)
    b0 = bs[:, 0]  # (n, chi, chi)
    chi = state.chi
    v = cplx.zeros((chi,), state.lam.dtype)
    v = C(v.re.at[0].set(1.0), v.im)

    def site(vc, bk):
        return cplx.einsum("a,ab->b", vc, bk), None

    v, _ = lax.scan(site, v, b0)
    return v[0]


@jax.jit
def global_cost_normalized(state: MPS):
    """1 - |<0...0|state>|^2 / <state|state> as ONE device program (one
    host sync instead of two; and chi >> true-rank f32 chains drift in
    scale, so the raw |z0|^2 alone is not trustworthy)."""
    nrm2 = mps_dot(state, state).re
    return 1.0 - overlap_with_zero(state).abs2() / jnp.maximum(nrm2, 1e-30)


@jax.jit
def softened_cost_terms(state: MPS):
    """(normalised global cost, normalised sum of Hamming-1 overlaps) in one
    device program — the softening penalty must share the |psi|^2
    normalisation or the softened cost is not scale-invariant."""
    nrm2 = jnp.maximum(mps_dot(state, state).re, 1e-30)
    cost = 1.0 - overlap_with_zero(state).abs2() / nrm2
    h1 = jnp.sum(hamming1_overlaps(state)) / nrm2
    return cost, h1


def amplitude(state: MPS, bits) -> C:
    """<bits|state> for a (n,) int array of bit values (little-endian site i
    = qubit i) — mps_operations.extract_amplitude analogue."""
    bs = b_tensors(state)
    chi = state.chi
    v = cplx.zeros((chi,), state.lam.dtype)
    v = C(v.re.at[0].set(1.0), v.im)

    def site(vc, x):
        bk, bit = x
        return cplx.einsum("a,ab->b", vc, bk[bit]), None

    v, _ = lax.scan(site, v, (bs, bits))
    return v[0]


def hamming1_overlaps(state: MPS):
    """|<e_i|state>|^2 for all n Hamming-weight-1 basis states e_i = 2^i,
    via prefix/suffix products of B[0] (aer_mps_backend.py:88-93)."""
    bs = b_tensors(state)
    b0 = bs[:, 0]
    b1 = bs[:, 1]
    chi = state.chi
    v0 = cplx.zeros((chi,), state.lam.dtype)
    v0 = C(v0.re.at[0].set(1.0), v0.im)

    def fwd(vc, bk):
        nv = cplx.einsum("a,ab->b", vc, bk)
        return nv, vc

    _, prefixes = lax.scan(fwd, v0, b0)       # prefixes[i] = prod_{k<i} B_k[0]

    def bwd(vc, bk):
        nv = cplx.einsum("ab,b->a", bk, vc)
        return nv, vc

    e_end = cplx.zeros((chi,), state.lam.dtype)
    e_end = C(e_end.re.at[0].set(1.0), e_end.im)
    _, suffixes_rev = lax.scan(bwd, e_end, jax.tree.map(lambda x: jnp.flip(x, 0), b0))
    suffixes = jax.tree.map(lambda x: jnp.flip(x, 0), suffixes_rev)  # suffixes[i] = prod_{k>i} B_k[0] e

    amps = cplx.einsum("ia,iab,ib->i", prefixes, b1, suffixes)
    return amps.abs2()


def z_expectations(state: MPS):
    """<Z_i> for every site using the canonical-form environments
    (mps_operations.mps_expectation analogue).

    Per-site self-normalised: w0+w1 at each site equals <psi|psi>, so
    (w0-w1)/(w0+w1) is the expectation of the NORMALISED state — invariant
    under the documented f32 scale drift (norm^2 up to 1.18 at n=50
    chi=128; docs/design_notes.md f32 item 4)."""
    bs = b_tensors(state)
    lam2 = state.lam[:-1] ** 2  # (n, chi)
    w = jnp.einsum("ia,ipab->ip", lam2, bs.abs2(),
                   precision=lax.Precision.HIGHEST)
    return (w[:, 0] - w[:, 1]) / jnp.maximum(w[:, 0] + w[:, 1], 1e-30)


def full_cost_terms(state: MPS, ref: MPS):
    """(global cost vs ref, local cost, hamming-1 overlap sum) of one state —
    the probe cost kernel for the full-cost device sweep. Semantics mirror
    the host backend layer: normalised global cost (evaluate_global_cost /
    aer_mps_backend.py:49-57), local cost 0.5(1 - mean <Z_q>) (:72-74),
    normalised hamming-1 sum (:88-93, shared |psi|^2 normalisation as in
    softened_cost_terms)."""
    nrm2 = jnp.maximum(mps_dot(state, state).re, 1e-30)
    g = 1.0 - mps_dot(ref, state).abs2() / nrm2
    loc = 0.5 * (1.0 - jnp.mean(z_expectations(state)))
    h1 = jnp.sum(hamming1_overlaps(state)) / nrm2
    return g, loc, h1


def local_overlap_matrix(r_state: MPS, l_state: MPS, q) -> C:
    """C[i,j] = <R| |i><j|_q |L> for the Rotosolve sweep — prefix/suffix
    transfer environments with open physical legs at site q.

    Both environment chains advance in ONE scan of n steps (the forward
    chain at site i and the backward chain at site n-1-i are independent),
    halving the sequential-step count: scans of chi^3 contractions are
    latency-bound, not FLOP-bound."""
    chi = l_state.chi
    br = b_tensors(r_state)
    bl = b_tensors(l_state)
    e0 = cplx.zeros((chi, chi), l_state.lam.dtype)
    e0 = C(e0.re.at[0, 0].set(1.0), e0.im)

    flipped = jax.tree.map(lambda v: jnp.flip(v, 0), (br, bl))

    def step(carry, x):
        e, f = carry
        (tr, tl), (trf, tlf) = x
        e_new = cplx.einsum("pax,ab,pby->xy", tr.conj(), e, tl)
        f_new = cplx.einsum("pxa,ab,pyb->xy", trf.conj(), f, tlf)
        return (e_new, f_new), (e, f)

    _, (prefixes, suffixes_rev) = lax.scan(step, (e0, e0),
                                           ((br, bl), flipped))
    suffixes = jax.tree.map(lambda v: jnp.flip(v, 0), suffixes_rev)
    # prefixes[k] = env of sites <k; suffixes[k] = env of sites >k

    e_q = prefixes[q]
    f_q = suffixes[q]
    brq = br[q]  # (2, chi, chi)
    blq = bl[q]
    return cplx.einsum("iax,ab,jby,xy->ij", brq.conj(), e_q, blq, f_q)


def all_pair_rdms(state: MPS):
    """rho(i, j) for all site pairs i < j: returns C (n, n, 4, 4) where entry
    [i, j] is the 2-site RDM with qubit i as the LSB (matching
    mps_operations.partial_trace / entanglement_measures.py:76-79).

    One left-anchored open-leg propagation per i, vmapped over i; each scan
    step emits the RDM for the current j. O(n^2 chi^3) total.
    """
    n, chi = state.n, state.chi
    bs = b_tensors(state)
    lam2 = state.lam[:-1] ** 2

    def for_i(i):
        bi = bs[i]  # (2, chi, chi)
        # T[p, p', a, b] = sum_c lam2[i][c] B_i[p][c,a] conj(B_i[p'][c,b])
        t0 = cplx.einsum("c,pca,qcb->pqab", lam2[i], bi, bi.conj())

        def step(t, j):
            valid = (j > i) & (j < n)
            jc = jnp.clip(j, 0, n - 1)
            bj = bs[jc]
            # rho[(pj,pi),(pj',pi')] = sum_ab T[pi,pi',a,b] sum_c B_j[pj][a,c] conj(B_j[pj'][b,c])
            rho = cplx.einsum("pqab,rac,sbc->rpsq", t, bj, bj.conj())
            rho = rho.reshape(4, 4)
            # propagate T through site j
            t_new = cplx.einsum("pqab,rax,rby->pqxy", t, bj, bj.conj())
            t = cplx.where(valid, t_new, t)
            rho = cplx.where(valid, rho, cplx.zeros((4, 4), state.lam.dtype))
            return t, rho

        _, rhos = lax.scan(step, t0, jnp.arange(n))
        return rhos  # (n, 4, 4); entry j valid when j > i

    return jax.vmap(for_i)(jnp.arange(n))


# -------------------------------------------------- host conversion utilities

def to_dense(state: MPS) -> np.ndarray:
    """Contract to a 2^n statevector (host, for tests / small n)."""
    b = cplx.to_np(state.b)
    n, _, chi, _ = b.shape
    psi = b[0]  # (2, chi, chi), left bond 0 only
    acc = psi[:, 0, :]  # (2, chi) physical index of site 0 first
    # accumulate: acc[(p0...pk), c]
    for i in range(1, n):
        acc = np.einsum("xc,pcd->xpd", acc, b[i]).reshape(-1, chi)
    vec = acc[:, 0]
    # vec index order: p0 p1 ... p_{n-1} with p0 slowest? We built x as
    # (p0, p1, ..., p_i) row-major: p0 is the most significant factor.
    # Little-endian qubit i = site i must be bit i of the basis index:
    # index = sum p_i 2^i, so p0 most significant in `vec`'s layout means we
    # must transpose.
    vec = vec.reshape([2] * n)          # axes (p0, ..., p_{n-1})
    vec = np.transpose(vec, range(n)[::-1])  # now axis 0 = p_{n-1}
    return vec.reshape(-1)


def from_dense(vec, chi: int, dtype=None) -> MPS:
    """Exact Vidal-form MPS of a dense little-endian statevector via
    sequential host SVDs (the Aer-MPS equivalent of consuming a
    set_statevector / initialize target). Schmidt ranks above `chi` are
    truncated with the discarded weight recorded in MPS.trunc."""
    dtype = dtype or config.real_dtype()
    v = np.asarray(vec, dtype=complex).ravel()
    n = int(np.log2(v.size))
    assert v.size == 2 ** n, "statevector length must be a power of 2"
    v = v / np.linalg.norm(v)
    # index = sum_i p_i 2^i -> tensor axes ordered (p_0, ..., p_{n-1})
    t = v.reshape([2] * n).transpose(range(n)[::-1])

    gre = np.zeros((n, 2, chi, chi))
    gim = np.zeros((n, 2, chi, chi))
    lam = np.zeros((n + 1, chi))
    lam[0, 0] = lam[n, 0] = 1.0
    discarded = 0.0

    m = t.reshape(1, -1)
    lam_left = np.ones(1)
    for i in range(n):
        chi_l = m.shape[0]
        m = m.reshape(chi_l * 2, -1)
        u, s, vh = np.linalg.svd(m, full_matrices=False)
        keep = min(int((s > 1e-14).sum()) or 1, chi)
        discarded += float((s[keep:] ** 2).sum())
        u, s, vh = u[:, :keep], s[:keep], vh[:keep]
        s = s / np.linalg.norm(s)
        a = u.reshape(chi_l, 2, keep)            # left-canonical site tensor
        inv_l = np.where(lam_left > 1e-14, 1.0 / np.maximum(lam_left, 1e-30),
                         0.0)
        for p in (0, 1):
            # B_i[p] = lam_i^+ A_i[p] diag(lam_{i+1}) (host f64, exact ranks)
            g = inv_l[:, None] * a[:, p, :] * s[None, :]
            gre[i, p, :chi_l, :keep] = g.real
            gim[i, p, :chi_l, :keep] = g.imag
        if i < n - 1:
            lam[i + 1, :keep] = s
        lam_left = s
        m = s[:, None] * vh
    return MPS(C(jnp.asarray(gre, dtype), jnp.asarray(gim, dtype)),
               jnp.asarray(lam, dtype),
               jnp.asarray(discarded, dtype))


def from_qiskit_mps(qmps, chi: int, dtype=None) -> MPS:
    """Import the Qiskit MPS format (list of (G0, G1) per site, list of
    lambda vectors per bond — constants.py:16-17): the stored Gamma tensors
    fold the right bond weights in to become B-form."""
    dtype = dtype or config.real_dtype()
    gams, lams = qmps
    n = len(gams)
    bre = np.zeros((n, 2, chi, chi))
    bim = np.zeros((n, 2, chi, chi))
    lam = np.zeros((n + 1, chi))
    lam[0, 0] = lam[n, 0] = 1.0
    for i, v in enumerate(lams):
        v = np.asarray(v)
        lam[i + 1, :v.size] = v
    for i, pair in enumerate(gams):
        lam_r = lam[i + 1, :]
        for p in (0, 1):
            m = np.asarray(pair[p])
            if m.ndim == 1:
                m = m.reshape(1, -1) if i == 0 else m.reshape(-1, 1)
            dl, dr = m.shape
            if dl > chi or dr > chi:
                raise ValueError(f"bond dim {m.shape} exceeds padded chi={chi}")
            bre[i, p, :dl, :dr] = m.real * lam_r[:dr]
            bim[i, p, :dl, :dr] = m.imag * lam_r[:dr]
    state = MPS(C(jnp.asarray(bre, dtype), jnp.asarray(bim, dtype)),
                jnp.asarray(lam, dtype), jnp.zeros((), dtype))
    # guard against non-canonical input (a properly Vidal-canonical Qiskit
    # MPS has norm 1 by construction, but nothing enforces callers pass
    # one): a silently unnormalised target makes every overlap cost
    # meaningless (cost 1-|z|^2 can go hugely negative and fake instant
    # convergence). Normalise in f64 on host.
    nrm2 = float(np.real(np.asarray(mps_dot(state, state).re)))
    if not np.isfinite(nrm2) or nrm2 <= 0:
        raise ValueError(f"qiskit MPS import has invalid norm^2 {nrm2}")
    if abs(nrm2 - 1.0) > 1e-6:
        scale = 1.0 / np.sqrt(nrm2)
        b = C(state.b.re.at[0].multiply(scale),
              state.b.im.at[0].multiply(scale))
        state = MPS(b, state.lam, state.trunc)
    return state


def to_qiskit_mps(state: MPS):
    """Export to the Qiskit MPS format, stripping bond padding (Gamma
    tensors are recovered host-side by unweighting the right bond — f64, so
    no device-precision amplification)."""
    b = cplx.to_np(state.b)
    lam = np.asarray(state.lam, dtype=np.float64)
    n = state.n
    dims = [1]
    for i in range(1, n):
        dims.append(max(int((lam[i] > 1e-14).sum()), 1))
    dims.append(1)
    gams = []
    lams = []
    for i in range(n):
        dl, dr = dims[i], dims[i + 1]
        lam_r = lam[i + 1, :dr] if i < n - 1 else np.ones(1)
        inv_r = np.where(lam_r > 1e-14, 1.0 / np.maximum(lam_r, 1e-30), 0.0)
        gams.append((b[i, 0, :dl, :dr] * inv_r, b[i, 1, :dl, :dr] * inv_r))
        if i < n - 1:
            lams.append(lam[i + 1, :dims[i + 1]])
    return gams, lams


def pad_chi(state: MPS, new_chi: int) -> MPS:
    """EXACT embedding of an MPS into a larger padded bond dimension (the
    extra rows/columns are zero, so every contraction is unchanged)."""
    n, chi = state.n, state.chi
    if new_chi < chi:
        raise ValueError("pad_chi cannot shrink the bond dimension")
    if new_chi == chi:
        return state
    dt = state.lam.dtype
    bre = jnp.zeros((n, 2, new_chi, new_chi), dt).at[:, :, :chi, :chi].set(
        state.b.re)
    bim = jnp.zeros((n, 2, new_chi, new_chi), dt).at[:, :, :chi, :chi].set(
        state.b.im)
    lam = jnp.zeros((n + 1, new_chi), dt).at[:, :chi].set(state.lam)
    return MPS(C(bre, bim), lam, state.trunc)


def regauge(state: MPS, new_chi: int) -> MPS:
    """Re-gauge an MPS into a different padded bond dimension.

    Growing is the exact zero-padding of :func:`pad_chi`. Shrinking keeps
    the ``new_chi`` largest Schmidt values at every bond (the same greedy
    per-bond truncation a capped 2q sweep applies) via a host-side
    qiskit-format round trip; :func:`from_qiskit_mps` renormalises, so the
    result is a valid unit-norm payload for a smaller working precision.
    Used by ``compile_with_chi_schedule`` to hand one engine-MPS target to
    stages of different working chi (the reference never needs this: Aer's
    bond dimension is a runtime value, aer_mps_backend.py:27-42)."""
    if new_chi == state.chi:
        return state
    if new_chi > state.chi:
        return pad_chi(state, new_chi)
    gams, lams = to_qiskit_mps(state)
    cut_gams, cut_lams = [], []
    keep_l = np.array([0])  # bond 0 is the trivial left edge
    for i in range(state.n):
        if i < state.n - 1:
            lam = np.asarray(lams[i])
            keep_r = np.argsort(-lam)[:new_chi]
            keep_r.sort()
            cut_lams.append(lam[keep_r])
        else:
            keep_r = np.array([0])
        g0, g1 = gams[i]
        cut_gams.append((np.asarray(g0)[np.ix_(keep_l, keep_r)],
                         np.asarray(g1)[np.ix_(keep_l, keep_r)]))
        keep_l = keep_r
    return from_qiskit_mps((cut_gams, cut_lams), new_chi)


def check_mps(obj) -> bool:
    """Heuristic type check mirroring aqc_research.check_mps usage
    (approximate_compiler.py:121)."""
    if isinstance(obj, MPS):
        return True
    if (isinstance(obj, tuple) and len(obj) == 2
            and isinstance(obj[0], (list, tuple))
            and isinstance(obj[1], (list, tuple))
            and len(obj[0]) > 0 and isinstance(obj[0][0], (tuple, list))):
        return True
    return False


# sites advanced per while-loop iteration in _env_probe. XLA while
# iterations carry a fixed dispatch/copy cost, far above the few chi^3
# contractions of one site step — amortise it by unrolling ENV_CHUNK masked
# site steps per iteration.
ENV_CHUNK = 8


class SweepEnv(NamedTuple):
    """Incremental probe-environment cache for one sweep (see
    optim.sweeps.EnvOps).

    e_buf[i] = env of sites < i between the sweep's current R and L states,
    valid for i <= e_ptr. g_buf[x] = env of sites > n-1-x (the RIGHT chain
    stored in reversed coordinates so both chains advance "upward"), valid
    for x <= g_ptr. Both buffers carry ENV_CHUNK rows of slack so chunked
    slab writes never clobber valid entries: positions past the frontier
    are garbage by definition and get overwritten before use."""
    e_buf: C           # (n + ENV_CHUNK, chi, chi)
    g_buf: C           # (n + ENV_CHUNK, chi, chi)
    e_ptr: jnp.ndarray  # int32 scalar
    g_ptr: jnp.ndarray  # int32 scalar


def _env_init(state: MPS) -> SweepEnv:
    n, chi = state.n, state.chi
    dt = state.lam.dtype
    buf = cplx.zeros((n + ENV_CHUNK, chi, chi), dt)
    bnd = C(buf.re.at[0, 0, 0].set(1.0), buf.im)
    return SweepEnv(bnd, bnd, jnp.int32(0), jnp.int32(0))


def _env_touch(env: SweepEnv, t0, t1, active) -> SweepEnv:
    """A gate touched sites [t0, t1] on either state: left envs stay valid
    up to position t0, right envs up to reversed position n-1-t1."""
    n = env.e_buf.re.shape[0] - ENV_CHUNK
    e_ptr = jnp.where(active, jnp.minimum(env.e_ptr, t0), env.e_ptr)
    g_ptr = jnp.where(active, jnp.minimum(env.g_ptr, n - 1 - t1), env.g_ptr)
    return SweepEnv(env.e_buf, env.g_buf,
                    e_ptr.astype(jnp.int32), g_ptr.astype(jnp.int32))


def _env_probe(env: SweepEnv, r_state: MPS, l_state: MPS, q, active=True):
    """Advance both environment frontiers to site q and contract
    C[i,j] = <R| |i><j|_q |L>.

    Trip counts are data-dependent (~|q - previous probe site| / ENV_CHUNK
    iterations — consecutive ADAPT probes sit on the same or nearby sites),
    so a window-Rotosolve probe costs O(distance) transfer steps instead of
    the O(n) full chain of local_overlap_matrix.

    `active=False` makes both while loops no-ops (and the returned C is
    garbage): the sweep calls probe UNCONDITIONALLY per gate so the big env
    buffers never cross a lax.cond boundary — conditioning on the buffers
    forces XLA to materialise per-gate copies, which costs more than the
    probe itself."""
    n, chi = r_state.n, r_state.chi
    br = b_tensors(r_state)
    bl = b_tensors(l_state)

    def slice_env(buf, i):
        z = jnp.zeros_like(i)
        re = lax.dynamic_slice(buf.re, (i, z, z), (1, chi, chi))[0]
        im = lax.dynamic_slice(buf.im, (i, z, z), (1, chi, chi))[0]
        return C(re, im)

    def slice_site(bs, i):
        z = jnp.zeros_like(i)
        re = lax.dynamic_slice(bs.re, (i, z, z, z), (1, 2, chi, chi))[0]
        im = lax.dynamic_slice(bs.im, (i, z, z, z), (1, 2, chi, chi))[0]
        return C(re, im)

    def write_slab(buf, i, slab):
        z = jnp.zeros_like(i)
        return C(lax.dynamic_update_slice(buf.re, slab.re, (i, z, z)),
                 lax.dynamic_update_slice(buf.im, slab.im, (i, z, z)))

    def make_advance(step_site, target):
        """Chunked frontier advance: ENV_CHUNK masked site steps + one slab
        write per while iteration."""
        def body(carry):
            buf, i = carry
            e = slice_env(buf, i)
            outs = []
            for p in range(ENV_CHUNK):
                e2 = step_site(e, i + p)
                e = cplx.where(i + p < target, e2, e)
                outs.append(e)
            slab = cplx.stack(outs)
            return write_slab(buf, i + 1, slab), jnp.minimum(
                i + ENV_CHUNK, target)

        return body

    # left chain: E_{i+1} = step(E_i, site i)
    def e_step(e, pos):
        site = jnp.minimum(pos, n - 1)
        return cplx.einsum("pax,ab,pby->xy", slice_site(br, site).conj(), e,
                           slice_site(bl, site))

    e_target = jnp.where(active, q, jnp.int32(-1))
    e_buf, e_ptr = lax.while_loop(lambda c: c[1] < e_target,
                                  make_advance(e_step, e_target),
                                  (env.e_buf, env.e_ptr))
    e_ptr = jnp.where(active, e_ptr, env.e_ptr)

    # right chain in reversed coordinates: G_{x+1} = step(G_x, site n-1-x)
    xq = n - 1 - q

    def g_step(f, pos):
        site = jnp.maximum(n - 1 - pos, 0)
        return cplx.einsum("pxa,ab,pyb->xy", slice_site(br, site).conj(), f,
                           slice_site(bl, site))

    g_target = jnp.where(active, xq, jnp.int32(-1))
    g_buf, g_ptr = lax.while_loop(lambda c: c[1] < g_target,
                                  make_advance(g_step, g_target),
                                  (env.g_buf, env.g_ptr))
    g_ptr = jnp.where(active, g_ptr, env.g_ptr)

    # the contraction runs only for probed gates; its operands are small
    # slices so this cond is cheap (conditioning the buffers would not be)
    def contract(ops):
        brq, e_q, blq, f_q = ops
        return cplx.einsum("iax,ab,jby,xy->ij", brq.conj(), e_q, blq, f_q)

    def skip(ops):
        return cplx.zeros((2, 2), r_state.lam.dtype)

    Cm = lax.cond(active, contract, skip,
                  (slice_site(br, q), slice_env(e_buf, q),
                   slice_site(bl, q), slice_env(g_buf, xq)))
    return Cm, SweepEnv(e_buf, g_buf, e_ptr, g_ptr)


_ENGINE_CACHE = {}


def sweep_engine(threshold: float, allow_env_cache=None):
    """SweepEngine for this threshold. Cached: jax.jit hashes the engine's
    function fields by identity, so returning fresh closures per call would
    silently retrace every sweep program on every minimize_cost call.

    Incremental probe environments (EnvOps) are OPT-IN via
    ADAPTAQC_ENVCACHE=1: FLOP-cheaper than full chains, and kept for larger
    n, where full chains scale O(n) but the incremental advance does not.
    Sharded runs pass allow_env_cache=False (the full-chain path is the
    GSPMD-partitionable one)."""
    import os
    use_env = (bool(os.environ.get("ADAPTAQC_ENVCACHE"))
               if allow_env_cache is None else bool(allow_env_cache))
    key = (float(threshold), use_env)
    engine = _ENGINE_CACHE.get(key)
    if engine is None:
        from ..optim.sweeps import EnvOps, SweepEngine
        apply_gate, apply_adj = make_apply(threshold)
        env_ops = EnvOps(_env_init, _env_touch, _env_probe) if use_env \
            else None
        engine = SweepEngine(
            f"mps[{threshold},env={use_env}]",
            apply_gate, apply_adj, local_overlap_matrix, mps_dot, env_ops,
            cost_terms=full_cost_terms)
        _ENGINE_CACHE[key] = engine
    return engine


@functools.partial(jax.jit, static_argnums=(5,))
def pair_op_overlaps(bra: MPS, ket: MPS, ops_a: C, ops_b: C, pairs,
                     max_dist: int):
    """<bra| A^{(k,m)} B^{(k,m)} |ket> for every (op k, pair p), summed over
    Schmidt terms m — the environment-cached replacement for
    `batched_op_overlaps` (same contract: A acts on site pairs[p, 1], B on
    pairs[p, 0], zero-padded terms contribute nothing; returns C (K, P)).

    Every operator insertion is local to the two pair sites, so the bra/ket
    transfer environments away from the pair are IDENTICAL for all (k, m, p).
    Compute left envs E_i (sites < i) and right envs F_i (sites > i) once
    (O(n chi^3)), then per pair build the 4-leg two-site overlap tensor
        W[u, v, w, z] = <bra| (|u><v| at lo) (|w><z| at hi) |ket>
    with (dist - 1) masked open-leg transfer steps through the middle sites,
    and read off every operator as a 16x16 dot with W. Replaces the K*M
    sequential n-site chains of batched_op_overlaps: the pair-selection
    heuristic drops from ~half of 50q compile wall-clock to noise.

    `max_dist` must be a static host-side bound on max |pairs[:,1] -
    pairs[:,0]| (1 for linear coupling maps -> the middle loop vanishes).
    """
    chi = bra.chi
    dt = bra.lam.dtype
    bb = b_tensors(bra)
    bk = b_tensors(ket)
    e0 = cplx.zeros((chi, chi), dt)
    e0 = C(e0.re.at[0, 0].set(1.0), e0.im)

    flipped = jax.tree.map(lambda v: jnp.flip(v, 0), (bb, bk))

    def step(carry, x):
        e, f = carry
        (tb, tk), (tbf, tkf) = x
        e_new = cplx.einsum("pax,ab,pby->xy", tb.conj(), e, tk)
        f_new = cplx.einsum("pxa,ab,pyb->xy", tbf.conj(), f, tkf)
        return (e_new, f_new), (e, f)

    _, (prefixes, suffixes_rev) = lax.scan(step, (e0, e0),
                                           ((bb, bk), flipped))
    suffixes = jax.tree.map(lambda v: jnp.flip(v, 0), suffixes_rev)
    # prefixes[i] = env of sites < i; suffixes[i] = env of sites > i

    def for_pair(pair):
        s0, s1 = pair[0], pair[1]
        lo = jnp.minimum(s0, s1)
        hi = jnp.maximum(s0, s1)
        e_lo = prefixes[lo]
        f_hi = suffixes[hi]
        blo_b, blo_k = bb[lo], bk[lo]
        bhi_b, bhi_k = bb[hi], bk[hi]
        # open-leg two-site chain: X[u, v, x, y] after site lo
        x_t = cplx.einsum("uax,ab,vby->uvxy", blo_b.conj(), e_lo, blo_k)
        for d in range(1, max_dist):
            mid = jnp.minimum(lo + d, bra.n - 1)
            x_new = cplx.einsum("pxa,uvxy,pyb->uvab",
                                bb[mid].conj(), x_t, bk[mid])
            x_t = cplx.where(lo + d < hi, x_new, x_t)
        # close at hi with the right environment
        w = cplx.einsum("wxa,uvxy,zyb,ab->uvwz",
                        bhi_b.conj(), x_t, bhi_k, f_hi)
        # leg groups: (u, v) at lo, (w, z) at hi. B acts on pairs[p, 0]:
        # when the pair arrives descending (s0 > s1), swap the groups so the
        # final contraction can always put B on the first pair of legs.
        w_swapped = C(w.re.transpose(2, 3, 0, 1), w.im.transpose(2, 3, 0, 1))
        return cplx.where(s0 <= s1, w, w_swapped)

    ws = jax.vmap(for_pair)(pairs)  # C (P, 2, 2, 2, 2)
    # value[k, p] = sum_m B_km[u, v] A_km[w, z] W_p[u, v, w, z]
    return cplx.einsum("kmuv,kmwz,puvwz->kp", ops_b, ops_a, ws)


def batched_op_overlaps(bra: MPS, ket: MPS, ops_a: C, ops_b: C, pairs):
    """<bra| A^{(t)} B^{(c)} |ket> for every (op k, Schmidt term m, pair p),
    summed over terms m.

    ops_a/ops_b: C (K, M, 2, 2) — A acts on site pairs[p, 1], B on
    pairs[p, 0]; zero-padded terms contribute nothing. Returns C (K, P).
    Used by the batched general_gradient pair scoring (utils/gradients.py,
    replacing the reference's per-pair Aer re-simulation gradients.py:81-122).

    Structure: lax.scan over the K*M operators (compact compile graph), with
    the P pair-lanes batched inside each site step.
    """
    chi = bra.chi
    dt = bra.lam.dtype
    bb = b_tensors(bra)
    bk = b_tensors(ket)
    k_n, m_n = ops_a.shape[0], ops_a.shape[1]
    p_n = pairs.shape[0]
    c_sites = pairs[:, 0]
    t_sites = pairs[:, 1]

    sites = jnp.arange(bra.n, dtype=jnp.int32)
    eye = cplx.eye(2, dt)

    def one_op(_, op_pair):
        a_op, b_op = op_pair  # C (2, 2) each

        e0 = cplx.zeros((p_n, chi, chi), dt)
        e0 = C(e0.re.at[:, 0, 0].set(1.0), e0.im)

        def site_step(e, x):
            i, tb, tk = x  # tb/tk: C (2, chi, chi)
            is_c = (i == c_sites).astype(dt)[:, None, None]  # (P, 1, 1)
            is_t = (i == t_sites).astype(dt)[:, None, None]
            o = C(eye.re[None] + is_c * (b_op.re[None] - eye.re[None])
                  + is_t * (a_op.re[None] - eye.re[None]),
                  eye.im[None] + is_c * (b_op.im[None] - eye.im[None])
                  + is_t * (a_op.im[None] - eye.im[None]))  # (P, 2, 2)
            e_new = cplx.einsum("qax,lqp,lab,pby->lxy", tb.conj(), o, e, tk)
            return e_new, None

        e, _ = lax.scan(site_step, e0, (sites, bb, bk))
        return None, e[:, 0, 0]  # C (P,)

    ops_flat = (ops_a.reshape(k_n * m_n, 2, 2), ops_b.reshape(k_n * m_n, 2, 2))
    _, vals = lax.scan(one_op, None, ops_flat)  # C (K*M, P)
    vals = vals.reshape(k_n, m_n, p_n)
    return vals.sum(axis=1)
