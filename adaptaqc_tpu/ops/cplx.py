"""Split-complex arithmetic layer: complex tensors as (re, im) real pairs.

The engine was first written for an accelerator backend without complex
dtypes, so all engine math runs on a `C` pytree of two real arrays. Complex
matmul lowers to 4 real matmuls; gates, overlaps and SVDs are expressed in
this representation throughout.

Complex SVD (needed for MPS bond truncation) is implemented via the
real-embedding eigendecomposition of theta^dagger theta: the embedding
R(H) = [[A, -B], [B, A]] of a Hermitian H = A + iB is real-symmetric with
every eigenvalue doubled; each real eigenvector [x; y] maps to a complex
eigenvector x + iy. A tiny diagonal epsilon-split keeps physically degenerate
Schmidt values (e.g. Bell/GHZ) from mixing across J-pairs. See svd().
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import tree_util


@tree_util.register_pytree_node_class
class C:
    """Complex tensor as a (re, im) pair of equal-shape real arrays."""

    __slots__ = ("re", "im")

    def __init__(self, re, im):
        self.re = re
        self.im = im

    def tree_flatten(self):
        return (self.re, self.im), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    # ---------------------------------------------------------- properties
    @property
    def shape(self):
        return self.re.shape

    @property
    def dtype(self):
        return self.re.dtype

    @property
    def ndim(self):
        return self.re.ndim

    # ---------------------------------------------------------- arithmetic
    def __add__(self, o):
        if isinstance(o, C):
            return C(self.re + o.re, self.im + o.im)
        return C(self.re + o, self.im)

    def __sub__(self, o):
        if isinstance(o, C):
            return C(self.re - o.re, self.im - o.im)
        return C(self.re - o, self.im)

    def __neg__(self):
        return C(-self.re, -self.im)

    def __mul__(self, o):
        if isinstance(o, C):
            return C(self.re * o.re - self.im * o.im,
                     self.re * o.im + self.im * o.re)
        if isinstance(o, complex):
            return self * scalar(o, self.dtype)
        return C(self.re * o, self.im * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, C):
            d = o.re * o.re + o.im * o.im
            return C((self.re * o.re + self.im * o.im) / d,
                     (self.im * o.re - self.re * o.im) / d)
        return C(self.re / o, self.im / o)

    def __matmul__(self, o):
        return matmul(self, o)

    def __getitem__(self, idx):
        return C(self.re[idx], self.im[idx])

    def conj(self):
        return C(self.re, -self.im)

    def mul_i(self):
        """Multiply by i."""
        return C(-self.im, self.re)

    @property
    def T(self):
        return C(self.re.T, self.im.T)

    @property
    def H(self):
        return C(self.re.T, -self.im.T)

    def abs2(self):
        return self.re * self.re + self.im * self.im

    def abs(self):
        return jnp.sqrt(self.abs2())

    def reshape(self, *shape):
        return C(self.re.reshape(*shape), self.im.reshape(*shape))

    def transpose(self, *axes):
        return C(self.re.transpose(*axes), self.im.transpose(*axes))

    def astype(self, dtype):
        return C(self.re.astype(dtype), self.im.astype(dtype))

    def sum(self, axis=None):
        return C(self.re.sum(axis), self.im.sum(axis))

    def __repr__(self):
        return f"C(shape={self.shape}, dtype={self.dtype})"


# ------------------------------------------------------------- constructors

def scalar(z, dtype=jnp.float32):
    return C(jnp.asarray(np.real(z), dtype), jnp.asarray(np.imag(z), dtype))


def from_np(arr, dtype=jnp.float32):
    arr = np.asarray(arr)
    return C(jnp.asarray(arr.real.copy(), dtype), jnp.asarray(arr.imag.copy(), dtype))


def to_np(c: C) -> np.ndarray:
    return np.asarray(c.re) + 1j * np.asarray(c.im)


def zeros(shape, dtype=jnp.float32):
    return C(jnp.zeros(shape, dtype), jnp.zeros(shape, dtype))


def eye(n, dtype=jnp.float32):
    return C(jnp.eye(n, dtype=dtype), jnp.zeros((n, n), dtype))


def stack(cs, axis=0):
    return C(jnp.stack([c.re for c in cs], axis),
             jnp.stack([c.im for c in cs], axis))


def concatenate(cs, axis=0):
    return C(jnp.concatenate([c.re for c in cs], axis),
             jnp.concatenate([c.im for c in cs], axis))


def where(cond, a: C, b: C):
    return C(jnp.where(cond, a.re, b.re), jnp.where(cond, a.im, b.im))


def expi(theta):
    """e^{i theta} elementwise."""
    return C(jnp.cos(theta), jnp.sin(theta))


# --------------------------------------------------------------- operations

def _mm(a, b):
    # Default-precision f32 matmuls may run in reduced precision on an
    # accelerator (TF32 on a GPU keeps ~3 decimal digits); quantum overlap and
    # SVD math needs true f32 accumulation.
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def matmul(a: C, b: C) -> C:
    """Complex matmul via 4 real matmuls (Karatsuba's 3 would trade one
    product for extra additions and a larger rounding error)."""
    if isinstance(a, C) and isinstance(b, C):
        return C(_mm(a.re, b.re) - _mm(a.im, b.im),
                 _mm(a.re, b.im) + _mm(a.im, b.re))
    if isinstance(a, C):
        return C(_mm(a.re, b), _mm(a.im, b))
    return C(_mm(a, b.re), _mm(a, b.im))


def einsum(spec, *ops):
    """Complex einsum over C / real operands (2^k real einsums)."""
    res_re = None
    res_im = None
    # expand product of (re + i*im) terms
    terms = [(op.re, op.im) if isinstance(op, C) else (op, None) for op in ops]

    def rec(i, acc_ops, phase):
        nonlocal res_re, res_im
        if i == len(terms):
            val = jnp.einsum(spec, *acc_ops,
                             precision=jax.lax.Precision.HIGHEST)
            # phase: 0 -> +re, 1 -> +im, 2 -> -re, 3 -> -im
            if phase % 2 == 0:
                sgn = 1.0 if phase == 0 else -1.0
                res_re = val * sgn if res_re is None else res_re + val * sgn
            else:
                sgn = 1.0 if phase == 1 else -1.0
                res_im = val * sgn if res_im is None else res_im + val * sgn
            return
        re, im = terms[i]
        rec(i + 1, acc_ops + [re], phase)
        if im is not None:
            rec(i + 1, acc_ops + [im], (phase + 1) % 4)

    rec(0, [], 0)
    if res_im is None:
        res_im = jnp.zeros_like(res_re)
    return C(res_re, res_im)


def vdot(a: C, b: C) -> C:
    """<a|b> = sum conj(a) * b."""
    re = jnp.sum(a.re * b.re + a.im * b.im)
    im = jnp.sum(a.re * b.im - a.im * b.re)
    return C(re, im)


def kron(a: C, b: C) -> C:
    if not isinstance(a, C):
        a = C(a, jnp.zeros_like(a))
    if not isinstance(b, C):
        b = C(b, jnp.zeros_like(b))
    return C(jnp.kron(a.re, b.re) - jnp.kron(a.im, b.im),
             jnp.kron(a.re, b.im) + jnp.kron(a.im, b.re))


def norm(a: C):
    return jnp.sqrt(jnp.sum(a.abs2()))


# ---------------------------------------------------------------- linalg

def embed_hermitian(h: C):
    """R(H) = [[A, -B], [B, A]] for Hermitian H = A + iB (real-symmetric)."""
    a, b = h.re, h.im
    top = jnp.concatenate([a, -b], axis=1)
    bot = jnp.concatenate([b, a], axis=1)
    return jnp.concatenate([top, bot], axis=0)


def eigh_top(h: C, keep: int):
    """Top-`keep` eigenpairs of a complex Hermitian matrix via real embedding.

    R(H) is real-symmetric with every eigenvalue of H doubled (the J-pair
    [x;y] ~ [-y;x] corresponds to the phase freedom of one complex
    eigenvector x+iy). Any real eigenvector of R(H) complexifies to an exact
    complex eigenvector, but for *degenerate* eigenvalues (e.g. the equal
    Schmidt values of a Bell pair) the solver may return a real basis whose
    complexifications are not complex-orthogonal. We therefore extract an
    orthonormal complex basis by greedy complex Gram-Schmidt over all 2k
    candidates in descending-eigenvalue order: candidates are processed
    cluster-by-cluster, so every accepted vector stays inside its eigenspace,
    and the 2k candidates always span the full complex space.

    Returns (w (keep,), V as C (keep, k) rows) with eigenvalues descending.
    """
    k = h.shape[-1]
    r = embed_hermitian(h)
    w2, v2 = jnp.linalg.eigh(r)  # ascending
    w2 = w2[::-1]
    v2 = v2[:, ::-1]
    # Scanning all 2k candidates is safe but wasteful: every complex
    # eigenvector contributes exactly 2 real candidates (its J-pair), and
    # greedy CGS over the first t descending-ordered candidates accepts at
    # least ceil(t/2) vectors (the complex span of t real candidates has
    # dimension >= t/2). The first 2*keep candidates therefore always yield
    # >= keep accepted vectors; a small margin absorbs f32 near-dependence
    # rejections inside degenerate clusters. Halves the sequential-scan
    # length at keep = k/2 (the bond-truncation case).
    n_cand = min(2 * keep + 8, 2 * k)
    w2 = w2[:n_cand]
    cand = C(v2[:k, :n_cand].T, v2[k:, :n_cand].T)  # (n_cand, k) rows

    dt = h.dtype

    def step(carry, x):
        basis_re, basis_im, eig_out, count = carry
        v, wj = x  # v: C row (k,)
        basis = C(basis_re, basis_im)

        def project_out(u):
            # subtract the projection onto accepted basis vectors
            # (unaccepted rows are zero)
            ov = C(_mm(basis.re, u.re) + _mm(basis.im, u.im),
                   _mm(basis.re, u.im) - _mm(basis.im, u.re))  # <basis_m|u>
            return u - C(_mm(ov.re, basis.re) - _mm(ov.im, basis.im),
                         _mm(ov.re, basis.im) + _mm(ov.im, basis.re))

        # classical Gram-Schmidt re-orthogonalised ("twice is enough",
        # Giraud et al.): a single CGS pass loses orthogonality in f32 for
        # near-degenerate clusters, and non-orthonormal Schmidt vectors make
        # repeated MPS bond updates drift off norm.
        v_res = project_out(project_out(v))
        nrm = jnp.sqrt(jnp.sum(v_res.abs2()))
        accept = (nrm > 1e-3) & (count < keep)
        inv = jnp.where(accept, 1.0 / jnp.maximum(nrm, 1e-30), 0.0)
        row = jnp.where(accept, count, keep - 1)  # dummy write when full
        onehot = (jnp.arange(keep) == row) & accept
        basis_re = jnp.where(onehot[:, None], v_res.re * inv, basis_re)
        basis_im = jnp.where(onehot[:, None], v_res.im * inv, basis_im)
        eig_out = jnp.where(onehot, wj, eig_out)
        return (basis_re, basis_im, eig_out, count + accept.astype(count.dtype)), None

    init = (jnp.zeros((keep, k), dt), jnp.zeros((keep, k), dt),
            jnp.zeros((keep,), dt), jnp.zeros((), jnp.int32))
    (basis_re, basis_im, eig_out, _), _ = jax.lax.scan(step, init, (cand, w2))
    return eig_out, C(basis_re, basis_im)


def tridiagonalize(h: C):
    """Complex Householder tridiagonalization H = Q T Q^H in split-complex.

    T is REAL symmetric tridiagonal (LAPACK zhetd2 semantics: each reflector
    is phased so the subdiagonal comes out real), Q is the product
    H_0^H H_1^H ... H_{n-2}^H of the elementary reflectors
    H_k = I - tau_k v_k v_k^H. This halves the native-eigh problem size vs
    the real embedding (eigh_top): R(H) is 2n x 2n where T is n x n.

    Returns (d (n,), e (n-1,), vrows C (n-1, n) with vrows[k] = v_k, tau
    C (n-1,)). v_k is zero on rows <= k and has v_k[k+1] = 1.
    """
    n = h.shape[-1]
    dt = h.dtype
    # Hermitize: the Gram matrices fed in carry f32 asymmetry noise
    ar0 = (h.re + h.re.T) * 0.5
    ai0 = (h.im - h.im.T) * 0.5
    idx = jnp.arange(n)

    def step(carry, k):
        ar, ai = carry
        colr = jnp.take(ar, k, axis=1)
        coli = jnp.take(ai, k, axis=1)
        m2 = idx > k + 1
        sel1 = (idx == k + 1).astype(dt)
        alpha_r = jnp.sum(sel1 * colr)
        alpha_i = jnp.sum(sel1 * coli)
        xnorm2 = jnp.sum(jnp.where(m2, colr * colr + coli * coli, 0.0))
        nrm = jnp.sqrt(alpha_r * alpha_r + alpha_i * alpha_i + xnorm2)
        # Scale-invariant zlarfg: normalise y = [alpha; x] first, so the
        # divisor |alpha^ - beta^|^2 >= 1 and no underflow floor is needed
        # (an absolute floor breaks reflector unitarity on rounding-noise
        # trailing blocks of rank-deficient matrices).
        active = nrm > 0
        inv = jnp.where(active, 1.0 / jnp.where(active, nrm, 1.0), 0.0)
        ahr = alpha_r * inv
        ahi = alpha_i * inv
        # beta^ = -sign(Re(alpha^)) (so |Re(alpha^ - beta^)| >= 1)
        bh = jnp.where(ahr >= 0, -1.0, 1.0)
        beta = jnp.where(active, bh * nrm, 0.0)
        # tau = (beta^ - alpha^) / beta^ = 1 - alpha^ * beta^  (beta^^2 = 1)
        tau_r = jnp.where(active, 1.0 - ahr * bh, 0.0)
        tau_i = jnp.where(active, -ahi * bh, 0.0)
        # v = [0..0, 1, x^ / (alpha^ - beta^)]
        dr = ahr - bh
        di = ahi
        dn = dr * dr + di * di
        safe_dn = jnp.where(active, dn, 1.0)
        vr = jnp.where(m2, (colr * dr + coli * di) * inv / safe_dn, 0.0) + sel1
        vi = jnp.where(m2, (coli * dr - colr * di) * inv / safe_dn, 0.0)

        # Hermitian similarity A <- H^H A H (the reflector zeroes the column
        # from the LEFT as H^H y = beta e1) = A - v w^H - w v^H with
        # u = A v, s = v^H u, w = tau (u - (conj(tau) s / 2) v)
        ur = _mm(ar, vr) - _mm(ai, vi)
        ui = _mm(ar, vi) + _mm(ai, vr)
        s_r = jnp.sum(vr * ur + vi * ui)
        s_i = jnp.sum(vr * ui - vi * ur)
        # t2 = conj(tau) * s / 2
        t2r = (tau_r * s_r + tau_i * s_i) * 0.5
        t2i = (tau_r * s_i - tau_i * s_r) * 0.5
        pr = ur - (t2r * vr - t2i * vi)
        pi = ui - (t2r * vi + t2i * vr)
        wr = tau_r * pr - tau_i * pi
        wi = tau_r * pi + tau_i * pr
        # (v w^H)_ij = v_i conj(w_j); (w v^H) = (v w^H)^H of the other term
        ar = ar - (vr[:, None] * wr[None, :] + vi[:, None] * wi[None, :]
                   + wr[:, None] * vr[None, :] + wi[:, None] * vi[None, :])
        ai = ai - (vi[:, None] * wr[None, :] - vr[:, None] * wi[None, :]
                   + wi[:, None] * vr[None, :] - wr[:, None] * vi[None, :])
        e_k = jnp.where(active, beta, 0.0)
        return (ar, ai), (e_k, vr, vi, tau_r, tau_i)

    (ar, ai), (e, vr, vi, tau_r, tau_i) = jax.lax.scan(
        step, (ar0, ai0), jnp.arange(n - 1))
    d = jnp.diagonal(ar)
    return d, e, C(vr, vi), C(tau_r, tau_i)


def apply_q(vrows: C, tau: C, z: C) -> C:
    """Apply Q = H_0 H_1 ... H_{n-2} (from tridiagonalize, where
    T = Q^H A Q) to the columns of z (n, m): the eigenvector back-transform.
    Each step is z <- z - tau_k v_k (v_k^H z), applied for k = n-2 .. 0."""

    def step(zc, xs):
        zr, zi = zc
        vr, vi, tr, ti = xs
        # y = v^H z (m,)
        yr = _mm(vr, zr) + _mm(vi, zi)
        yi = _mm(vr, zi) - _mm(vi, zr)
        # z -= (tau v) y^T
        cvr = tr * vr - ti * vi
        cvi = tr * vi + ti * vr
        zr = zr - (cvr[:, None] * yr[None, :] - cvi[:, None] * yi[None, :])
        zi = zi - (cvr[:, None] * yi[None, :] + cvi[:, None] * yr[None, :])
        return (zr, zi), None

    xs = (vrows.re[::-1], vrows.im[::-1], tau.re[::-1], tau.im[::-1])
    (zr, zi), _ = jax.lax.scan(step, (z.re, z.im), xs)
    return C(zr, zi)


def eigh_top_tridiag(h: C, keep: int):
    """eigh_top via complex tridiagonalization: T = Q^H H Q real tridiagonal,
    native real eigh at size n (vs 2n for the real embedding), eigenvectors
    Q z_i back-transformed only for the kept columns. Orthonormality is
    structural (Q unitary, z orthonormal), so no Gram-Schmidt pass is needed
    even on exactly degenerate spectra (Bell/GHZ)."""
    n = h.shape[-1]
    d, e, vrows, tau = tridiagonalize(h)
    t = jnp.diag(d) + jnp.diag(e, 1) + jnp.diag(e, -1)
    w, z = jnp.linalg.eigh(t)  # ascending
    w = w[::-1][:keep]
    zk = z[:, ::-1][:, :keep]
    v = apply_q(vrows, tau, C(zk, jnp.zeros_like(zk)))  # (n, keep) columns
    return w, C(v.re.T, v.im.T)


# eigh_top implementation selector for svd_trunc: "embed" (real embedding +
# greedy CGS2, the default) or "tridiag" (half-size native eigh after a
# lax.scan Householder pass). Read from the environment at TRACE time (not
# import time), so setting ADAPTAQC_EIGH after import works; already-jitted
# engine programs still close over the value they traced with — use
# set_eigh_impl() (or jax.clear_caches()) to flip it mid-process.
import os as _os

EIGH_IMPLS = ("embed", "tridiag")
EIGH_IMPL = ""  # programmatic override; wins over the environment


def _eigh_impl() -> str:
    impl = EIGH_IMPL or _os.environ.get("ADAPTAQC_EIGH", "") or "embed"
    if impl not in EIGH_IMPLS:
        raise ValueError(f"unknown eigh impl {impl!r}; expected one of "
                         f"{EIGH_IMPLS}")
    return impl


def set_eigh_impl(impl: str):
    """Flip the eigh implementation at runtime ('' = environment/default).

    Clears jit caches: compiled engine programs baked in the previous
    choice and would otherwise silently keep using it."""
    global EIGH_IMPL
    if impl not in ("",) + EIGH_IMPLS:
        raise ValueError(f"unknown eigh impl {impl!r}")
    EIGH_IMPL = impl
    jax.clear_caches()


def svd_trunc(theta: C, chi_keep: int, threshold: float):
    """Truncated SVD of complex theta (m x n), top chi_keep singular values.

    Returns (U (m, chi_keep), s (chi_keep,), Vh (chi_keep, n)), singular
    values descending; values below `threshold` are zeroed (Aer's
    matrix_product_state_truncation_threshold semantics,
    /root/reference/adaptaqc/backends/aer_mps_backend.py:27-42).

    Computed from eigh(theta^H theta) in split-complex arithmetic:
    V rows = eigenvectors, s = sqrt(eigenvalues), U = theta V^H / s.
    """
    m, n = theta.shape
    h = theta.H @ theta  # (n, n) Hermitian PSD
    if _eigh_impl() == "tridiag":
        w, vrows = eigh_top_tridiag(h, chi_keep)
    else:
        w, vrows = eigh_top(h, chi_keep)  # descending; vrows[i] = v_i
    # theta = U S V^H with V columns v_i: U = theta V / s, Vh rows = conj(v_i).
    # s is taken from the ACTUAL column norms ||theta v_i|| rather than
    # sqrt(eigh(theta^H theta)) — on rank-deficient inputs the Gram's noise
    # eigenvalues can be arbitrarily tiny (observed 1e-32 in f32) while the
    # CGS basis row v_i still overlaps the true support, so dividing theta
    # v_i by sqrt(w_i) manufactured U columns of norm up to ~1e16 and the
    # center-gauge engine's norm exploded by 24 decades over one circuit
    # (round-5 bug: cross_engine_overlap 6e-8 vs dense truth 0.99 at n=8).
    # The column norm is linear in theta (no squaring loss), so small
    # singular values also come out MORE accurate than via the Gram.
    u = theta @ vrows.T  # (m, chi_keep); columns theta v_i have norm s_i
    s = jnp.sqrt(jnp.sum(u.abs2(), axis=0))
    # columns below the dtype's relative noise floor are unresolvable
    # Gram-noise directions (they lie inside the true column space, i.e.
    # DUPLICATE real directions): zero them even when threshold == 0, or
    # gauge moves would accumulate non-isometric junk
    floor = 8.0 * jnp.finfo(theta.re.dtype).eps * jnp.max(s)
    keep = (s > threshold) & (s > floor)
    s_k = jnp.where(keep, s, 0.0)
    inv_s = jnp.where(keep, 1.0 / jnp.maximum(s, 1e-30), 0.0)
    u = C(u.re * inv_s, u.im * inv_s)
    vh = vrows.conj()
    vh = C(vh.re * keep[:, None], vh.im * keep[:, None])
    return u, s_k, vh
