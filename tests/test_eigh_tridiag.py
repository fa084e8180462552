"""Tridiagonalization-based complex eigh (cplx.eigh_top_tridiag).

The alternative bond-truncation path (ADAPTAQC_EIGH=tridiag): complex
Householder tridiagonalization -> native REAL eigh at size n (vs 2n for the
real embedding) -> back-transform of the kept columns. These tests pin (a) f64
exactness against numpy, (b) f32 accuracy parity with the embed path on the
degenerate spectra that broke naive extraction (CLAUDE.md caveat), and (c)
end-to-end MPS-engine equivalence when the implementation is switched.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from adaptaqc_tpu.ops import cplx


def _as_c(h, dtype=jnp.float64):
    return cplx.C(jnp.asarray(h.real, dtype), jnp.asarray(h.imag, dtype))


def _cases(rng):
    cases = {}
    a = rng.standard_normal((12, 12)) + 1j * rng.standard_normal((12, 12))
    cases["random"] = a.conj().T @ a
    q, _ = np.linalg.qr(rng.standard_normal((16, 16))
                        + 1j * rng.standard_normal((16, 16)))
    w = np.repeat([4.0, 1.0, 0.25, 0.0], 4)
    cases["degenerate_clusters"] = (q * w) @ q.conj().T
    a = rng.standard_normal((12, 3)) + 1j * rng.standard_normal((12, 3))
    cases["rank3"] = a @ a.conj().T
    th = np.zeros((4, 4), complex)
    th[0, 0] = th[3, 3] = 1 / np.sqrt(2)  # Bell two-site Gram
    cases["bell"] = th.conj().T @ th
    cases["flat"] = np.eye(8, dtype=complex)
    cases["zero"] = np.zeros((6, 6), complex)
    return cases


@pytest.mark.parametrize("name", ["random", "degenerate_clusters", "rank3",
                                  "bell", "flat", "zero"])
def test_eigh_top_tridiag_f64_exact(name):
    h = _cases(np.random.default_rng(0))[name]
    n = h.shape[0]
    keep = max(1, n // 2)
    w, v = cplx.eigh_top_tridiag(_as_c(h), keep)
    w = np.asarray(w)
    V = np.asarray(v.re) + 1j * np.asarray(v.im)  # rows v_i^T
    wref = np.linalg.eigvalsh(h)[::-1][:keep]
    scale = max(1.0, np.abs(wref).max())
    assert np.abs(w - wref).max() / scale < 1e-12
    # eigen-residual and orthonormality are structural (Q unitary)
    for i in range(keep):
        assert np.linalg.norm(h @ V[i] - w[i] * V[i]) / scale < 1e-12
    assert np.abs(V @ V.conj().T - np.eye(keep)).max() < 1e-12


def test_tridiagonalize_reconstructs():
    rng = np.random.default_rng(1)
    n = 10
    a = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    h = a.conj().T @ a
    d, e, vrows, tau = cplx.tridiagonalize(_as_c(h))
    t = np.diag(np.asarray(d)) + np.diag(np.asarray(e), 1) \
        + np.diag(np.asarray(e), -1)
    qc = cplx.apply_q(vrows, tau, cplx.C(jnp.eye(n, dtype=jnp.float64),
                                         jnp.zeros((n, n), jnp.float64)))
    q = np.asarray(qc.re) + 1j * np.asarray(qc.im)
    assert np.abs(q @ q.conj().T - np.eye(n)).max() < 1e-13
    assert np.abs(q @ t @ q.conj().T - h).max() < 1e-11 * np.abs(h).max()


def test_eigh_top_tridiag_f32_degenerate_orthonormal():
    """The embed path's worst case (maximally degenerate spectra, J-pair
    mixing): the tridiag path must return orthonormal vectors structurally,
    without any Gram-Schmidt pass."""
    rng = np.random.default_rng(0)
    cases = [("flat", np.eye(64, dtype=complex), 32)]
    a = rng.normal(size=(64, 64)) + 1j * rng.normal(size=(64, 64))
    q, _ = np.linalg.qr(a)
    w = np.repeat(np.linspace(1, 0.1, 8), 8)
    cases.append(("clusters", (q * w) @ q.conj().T, 32))
    cases.append(("full", np.eye(16, dtype=complex), 16))
    for name, h, keep in cases:
        _, v = cplx.eigh_top_tridiag(_as_c(h, jnp.float32), keep)
        V = np.asarray(v.re) + 1j * np.asarray(v.im)
        assert (np.linalg.norm(V, axis=1) > 0.5).all(), name
        assert np.abs(V @ V.conj().T - np.eye(keep)).max() < 1e-4, name


def test_eigh_top_tridiag_f32_matches_embed_accuracy():
    """On an engine-realistic spectrum (7 decades of singular values) the
    tridiag path's f32 top-subspace error must be no worse than ~2x the
    embed path's."""
    rng = np.random.default_rng(5)
    n = 128
    a = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    u, _, vh = np.linalg.svd(a)
    s = np.logspace(0, -7, n)
    h = ((u * s) @ vh).conj().T @ ((u * s) @ vh)
    hc = _as_c(h, jnp.float32)
    wx, vx = np.linalg.eigh(h)
    top = vx[:, ::-1][:, :8]
    proj = (top @ top.conj().T).conj()  # row-vector projector

    def top8_err(v):
        V = np.asarray(v.re) + 1j * np.asarray(v.im)
        return np.linalg.norm(V[:8] @ proj - V[:8])

    _, v_tri = cplx.eigh_top_tridiag(hc, n // 2)
    _, v_emb = cplx.eigh_top(hc, n // 2)
    assert top8_err(v_tri) < max(2 * top8_err(v_emb), 1e-5)


def test_svd_trunc_impl_equivalence_bell_ghz():
    """svd_trunc under the tridiag impl reproduces the embed impl's
    truncated factorisation (U S V^H and the kept spectrum) on the
    degenerate Bell/GHZ-type thetas."""
    rng = np.random.default_rng(2)
    thetas = []
    th = np.zeros((4, 4), complex)
    th[0, 0] = th[3, 3] = 1 / np.sqrt(2)
    thetas.append(th)  # Bell
    a = rng.standard_normal((8, 8)) + 1j * rng.standard_normal((8, 8))
    thetas.append(a / np.linalg.norm(a))
    old = cplx.EIGH_IMPL
    try:
        for th in thetas:
            tc = cplx.C(jnp.asarray(th.real, jnp.float32),
                        jnp.asarray(th.imag, jnp.float32))
            keep = th.shape[0] // 2
            outs = {}
            for impl in ("embed", "tridiag"):
                cplx.EIGH_IMPL = impl
                u, s, vh = cplx.svd_trunc(tc, keep, 1e-7)
                U = np.asarray(u.re) + 1j * np.asarray(u.im)
                Vh = np.asarray(vh.re) + 1j * np.asarray(vh.im)
                outs[impl] = (U, np.asarray(s), Vh)
            np.testing.assert_allclose(outs["embed"][1], outs["tridiag"][1],
                                       atol=1e-5)
            rec_e = (outs["embed"][0] * outs["embed"][1]) @ outs["embed"][2]
            rec_t = (outs["tridiag"][0] * outs["tridiag"][1]) \
                @ outs["tridiag"][2]
            np.testing.assert_allclose(rec_e, rec_t, atol=1e-5)
            if np.linalg.matrix_rank(th) <= keep:
                np.testing.assert_allclose(rec_t, th, atol=1e-5)
    finally:
        cplx.EIGH_IMPL = old


def test_mps_engine_equivalence_under_tridiag():
    """End-to-end MPS circuit simulation with the tridiag eigh matches the
    dense statevector, including on GHZ (exactly degenerate Schmidt values
    at every bond)."""
    from test_mps_core import run_mps
    from test_sv_core import random_circuit, simulate
    from adaptaqc_tpu.backends import mps_core
    from adaptaqc_tpu.circuits.circuit import Circuit

    ghz = Circuit(5)
    ghz.h(0)
    for i in range(4):
        ghz.cx(i, i + 1)
    rng = np.random.default_rng(11)
    rand = random_circuit(5, 25, rng)

    old = cplx.EIGH_IMPL
    try:
        cplx.EIGH_IMPL = "tridiag"
        jax.clear_caches()
        for qc in (ghz, rand):
            st = run_mps(qc, 8)
            np.testing.assert_allclose(mps_core.to_dense(st), simulate(qc),
                                       atol=1e-5)
    finally:
        cplx.EIGH_IMPL = old
        jax.clear_caches()


def _spectral_case(case, rng, n=32):
    if case == "rand":
        a = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        return a.conj().T @ a
    if case == "spec7":
        a = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        u, _, vh = np.linalg.svd(a)
        th = (u * np.logspace(0, -7, n)) @ vh
        return th.conj().T @ th
    if case == "flat":
        return np.eye(n, dtype=complex)
    if case == "lowrank":
        a = rng.standard_normal((n, 4)) + 1j * rng.standard_normal((n, 4))
        return a @ a.conj().T
    # decoupled: exact zero bond splits T into independent blocks
    a = rng.standard_normal((n, n))
    h = a.T @ a
    h[: n // 2, n // 2:] = 0.0
    h[n // 2:, : n // 2] = 0.0
    return h.astype(complex)


@pytest.mark.parametrize("impl", ["embed", "tridiag"])
@pytest.mark.parametrize("case", ["rand", "spec7", "flat", "lowrank",
                                  "decoupled"])
def test_eigh_top_matches_numpy(impl, case):
    """Both device eigh paths agree with numpy.linalg.eigh in f32:
    eigenvalues, orthonormality, residuals and top-subspace recovery on
    degenerate/decoupled Gram spectra (the svd_trunc input class)."""
    h = _spectral_case(case, np.random.default_rng(7))
    n = h.shape[0]
    hc = _as_c(h, jnp.float32)
    keep = n // 2
    fn = cplx.eigh_top if impl == "embed" else cplx.eigh_top_tridiag
    w_p, v_p = fn(hc, keep)
    wx = np.linalg.eigh(np.asarray(hc.re) + 1j * np.asarray(hc.im))[0][::-1]
    w_p = np.asarray(w_p)
    scale = max(1e-30, np.abs(wx).max())
    # ~10 * (2n) * eps_f32: embed solves the 2n x 2n real embedding
    assert np.abs(w_p - wx[:keep]).max() / scale < 1e-4
    V = np.asarray(v_p.re) + 1j * np.asarray(v_p.im)
    assert np.abs(V @ V.conj().T - np.eye(keep)).max() < 2e-4
    for i in range(4):
        assert np.linalg.norm(h @ V[i] - w_p[i] * V[i]) / scale < 2e-4


def test_eigh_impl_rejects_unknown_name(monkeypatch):
    """ADAPTAQC_EIGH names one of the two device paths; anything else (the
    removed kernel names included) is an error, not a silent default."""
    monkeypatch.setenv("ADAPTAQC_EIGH", "teig")
    prev = cplx.EIGH_IMPL
    try:
        cplx.EIGH_IMPL = ""
        with pytest.raises(ValueError):
            cplx._eigh_impl()
        monkeypatch.delenv("ADAPTAQC_EIGH")
        assert cplx._eigh_impl() == "embed"
        with pytest.raises(ValueError):
            cplx.set_eigh_impl("pallas")
    finally:
        cplx.EIGH_IMPL = prev
