"""Smoke run of the ADAPT-AQC compile path on one NVIDIA GPU.

One process that opens the card once and runs, in order:

  device   the platform must be "gpu"; prints device kind and count, the JAX
           and jaxlib versions, XLA_FLAGS, the card's name and power limit
           (nvidia-smi, in a child process that stays off JAX) and whether
           the native circuit helper loaded;
  kernels  the two eigh paths (embed, tridiag) through svd_trunc against
           numpy's f64 SVD on two-site matrices of a real n=50 chi=64 state,
           one of them GHZ (exactly degenerate). The repository has no
           hand-written kernel: every device op is XLA's (cuSOLVER for eigh);
  compile  a 50-qubit chi=2 random MPS target compiled by AdaptCompiler on
           the MPS backend at max_chi=64 with the paper's configuration, for
           a fixed number of layers, checked by the independent center-gauge
           engine; then the README example on the statevector backend;
  sweep    the n=50 chi=64 fused Rotoselect sweep of bench.py.

Any failure exits non-zero. The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Usage:
  python chip_smoke.py           one card, all phases
  python chip_smoke.py --four    four cards: only the sharded-mesh phase
                                 (make_mps_training_step, make_training_step
                                 and MPSBackend(mesh=...) through
                                 AdaptCompiler, each against one card)
"""

import argparse
import json
import logging
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# kept singular values (sorted) against numpy f64, relative to the largest:
# the Gram route squares the spectrum, so values near sqrt(eps_f32) * s_max
# carry errors of that order (~6 sqrt(eps_f32))
SVAL_TOL = 2e-3
# ||theta - U S V^H||_F / ||theta||_F beyond the optimal truncation error
RECON_TOL = 1e-3
# max |(US)^H (US) - S^2| / s_max^2: U orthonormal where it carries weight
# (columns of singular values near the f32 noise floor are not resolvable)
ORTHO_TOL = 1e-4
# |in-loop overlap - center-gauge overlap|: two f32 engines at the same chi
# with different gauges and truncation algebra
CROSS_TOL = 2e-3


def log(msg):
    print(msg, flush=True)


def _require_checkout():
    if not os.path.isdir(os.path.join(HERE, "adaptaqc_tpu")):
        raise SystemExit("chip_smoke.py must run from a checkout of the "
                         "repository (adaptaqc_tpu/ not found beside it)")
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "benchmarks"))


def _require_gpu(count):
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX found {devs[0].platform!r} devices "
                         f"{devs}; this smoke run does not fall back")
    if len(devs) < count:
        raise SystemExit(f"need {count} GPUs, JAX found {len(devs)}")
    return devs


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


# ------------------------------------------------------------------ device
def phase_device():
    import jax
    import jaxlib
    from adaptaqc_tpu.ops import native
    devs = jax.devices()
    log(f"[device] kind={devs[0].device_kind!r} count={len(devs)} "
        f"jax={jax.__version__} jaxlib={jaxlib.__version__}")
    log(f"[device] XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"[device] nvidia-smi name,power.limit: {nvidia_smi()}")
    log(f"[device] native helper loaded: {native.available()}")


# ----------------------------------------------------------------- kernels
def _brickwall(n, depth, seed, ghz=False, angle=3.0, rz=True):
    """Random ry (and rz) layers, angles in [-angle, angle], between CX
    bricks; or the GHZ preparation circuit."""
    from adaptaqc_tpu.circuits.circuit import Circuit
    rng = np.random.default_rng(seed)
    qc = Circuit(n)
    if ghz:
        qc.h(0)
        for q in range(n - 1):
            qc.cx(q, q + 1)
        return qc
    for layer in range(depth):
        for q in range(n):
            qc.ry(float(rng.uniform(-angle, angle)), q)
            if rz:
                qc.rz(float(rng.uniform(-angle, angle)), q)
        for q in range(layer % 2, n - 1, 2):
            qc.cx(q, q + 1)
    return qc


def two_site_theta(state, k):
    """theta = diag(lam_k) B_k B_{k+1} as a (2chi, 2chi) complex matrix —
    the input class of the 2q apply's truncated SVD."""
    from adaptaqc_tpu.ops import cplx
    b = cplx.to_np(state.b)
    lam = np.asarray(state.lam)
    chi = b.shape[-1]
    t = np.einsum("a,pac,qcb->apqb", lam[k], b[k], b[k + 1])
    return t.reshape(2 * chi, 2 * chi)


def check_eigh_paths(n, chi, depth, threshold=1e-8):
    """{(impl, case): (sval_err, recon_excess, ortho_err)} of svd_trunc under
    both eigh paths against numpy's f64 SVD of the same f32 matrix."""
    import jax
    import jax.numpy as jnp
    from adaptaqc_tpu.backends import mps_core
    from adaptaqc_tpu.circuits.tape import compile_tape
    from adaptaqc_tpu.ops import cplx

    run = jax.jit(mps_core.apply_tape, static_argnums=(5,))
    thetas = {}
    for case, ghz in (("random", False), ("ghz", True)):
        tape = compile_tape(_brickwall(n, depth, seed=3, ghz=ghz))
        st = run(mps_core.zero_mps(n, chi, jnp.float32),
                 jnp.asarray(tape.kinds), jnp.asarray(tape.q0),
                 jnp.asarray(tape.q1), jnp.asarray(tape.angles), threshold)
        thetas[case] = two_site_theta(st, n // 2 - 1)

    out = {}
    prev = cplx.EIGH_IMPL
    try:
        for impl in cplx.EIGH_IMPLS:
            cplx.EIGH_IMPL = impl
            svd = jax.jit(lambda t: cplx.svd_trunc(t, chi, threshold))
            for case, th in thetas.items():
                th = th.astype(np.complex64).astype(np.complex128)
                u, s, vh = svd(cplx.from_np(th.astype(np.complex64)))
                s = np.asarray(s, np.float64)
                full = np.linalg.svd(th, compute_uv=False)
                ref = np.where(full[:chi] > threshold, full[:chi], 0.0)
                s_err = float(np.abs(np.sort(s)[::-1] - ref).max() / ref[0])
                us = cplx.to_np(u) * s
                nrm = np.linalg.norm(th)
                recon = np.linalg.norm(th - us @ cplx.to_np(vh)) / nrm
                optimal = np.sqrt(np.sum(full[chi:] ** 2)) / nrm
                o_err = float(np.abs(us.conj().T @ us - np.diag(s ** 2)).max()
                              / ref[0] ** 2)
                out[(impl, case)] = (s_err, float(recon - optimal), o_err)
                if case == "ghz":
                    # exactly degenerate pair (1/sqrt2, 1/sqrt2), rest zero
                    if (s > 0).sum() != 2:
                        raise AssertionError(f"{impl}: GHZ rank {s[:4]}")
    finally:
        cplx.EIGH_IMPL = prev
    return out


def phase_kernels():
    t0 = time.time()
    checks = check_eigh_paths(50, 64, 10)
    for (impl, case), (s_err, recon, o_err) in checks.items():
        log(f"[kernels] svd_trunc eigh={impl} {case} n=50 chi=64: "
            f"sval err {s_err:.3e} (tol {SVAL_TOL:.0e}), recon excess "
            f"{recon:.3e} (tol {RECON_TOL:.0e}), weighted |U^H U - I| "
            f"{o_err:.3e} (tol {ORTHO_TOL:.0e})")
        if not (s_err <= SVAL_TOL and recon <= RECON_TOL
                and o_err <= ORTHO_TOL):
            raise AssertionError(f"eigh path {impl} off on {case}")
    log(f"[kernels] done in {time.time() - t0:.1f}s")


# ----------------------------------------------------------------- compile
class _LayerClock(logging.Handler):
    """Timestamps of the compiler's per-layer log line."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.starts = []

    def emit(self, record):
        if record.getMessage().startswith("global cost entering layer"):
            self.starts.append(time.perf_counter())


def run_compile(n, max_chi, layers, seed=1, mesh=None):
    """(target, result, seconds per layer, wall) of a fixed-layer compile of
    the seeded random-MPS target with the paper's configuration."""
    from random_mps import make_compiler, random_target
    qmps = random_target(seed, n=n, chi=2)
    # sufficient_cost 0 and no plateau stop: exactly `layers` layers run
    compiler = make_compiler(qmps, max_chi, sufficient_cost=0.0,
                             max_layers=layers, mesh=mesh)
    clock = _LayerClock()
    lg = logging.getLogger("adaptaqc_tpu")
    old_level = lg.level
    lg.setLevel(logging.INFO)
    lg.addHandler(clock)
    np.random.seed(seed)
    t0 = time.perf_counter()
    try:
        result = compiler.compile()
    finally:
        lg.removeHandler(clock)
        lg.setLevel(old_level)
    t1 = time.perf_counter()
    marks = clock.starts + [t1]
    return qmps, result, np.diff(marks), t1 - t0


def phase_compile(n=50, max_chi=64, layers=8):
    from adaptaqc_tpu.utils.verification import cross_engine_overlap
    qmps, result, per_layer, wall = run_compile(n, max_chi, layers)
    steady = float(np.median(per_layer[1:])) if len(per_layer) > 1 else None
    log(f"[compile] n={n} max_chi={max_chi}: layers={len(per_layer)} "
        f"cost_evaluations={result.cost_evaluations} "
        f"overlap={result.overlap:.6f} wall={wall:.1f}s")
    later = "n/a" if steady is None else f"{steady:.3f}s"
    log(f"[compile] first layer (incl. XLA compile) {per_layer[0]:.1f}s; "
        f"median of later layers {later} (a layer that grows the tape "
        f"bucket recompiles); all: {[round(float(x), 2) for x in per_layer]}")
    ov = cross_engine_overlap(qmps, result.circuit, chi=max_chi)
    diff = abs(ov - result.overlap)
    log(f"[compile] center-gauge check: {ov:.6f} vs in-loop "
        f"{result.overlap:.6f}, |diff| {diff:.2e} (tol {CROSS_TOL:.0e})")
    if not (np.isfinite(result.overlap) and 0.0 <= result.overlap <= 1.0
            and len(per_layer) == layers and diff <= CROSS_TOL):
        raise AssertionError("compile phase failed its checks")
    return result


def phase_readme():
    import runpy
    ns = runpy.run_path(os.path.join(HERE, "examples", "readme_example.py"),
                        run_name="readme_example")
    ov = float(ns["result"].overlap)
    log(f"[compile] README example (statevector backend): overlap {ov:.6f}")
    if not ov > 0.99:
        raise AssertionError(f"README example overlap {ov} <= 0.99")


# ------------------------------------------------------------------- sweep
def phase_sweep(smi):
    from bench import run_sweep_benchmark
    n, chi, layers = 50, 64, 12
    eps, per_sweep, dt, _ = run_sweep_benchmark(n, chi, layers, iters=10)
    if not (np.isfinite(eps) and eps > 0):
        raise AssertionError(f"sweep rate {eps}")
    log(f"[sweep] n={n} chi={chi}: {dt * 1e3:.3f} ms/sweep, "
        f"{eps:.1f} equivalent evals/s ({per_sweep} evals/sweep) on {smi}")


# -------------------------------------------------------------------- four
# |sharded - one device| for costs, RDM entries and swept angles: the same
# f32 program partitioned differently sums in another order
FOUR_TOL = 1e-4


def phase_four(n_mps=50, chi=64, n_sv=24, adapt_n=50, adapt_layers=2,
               n_devices=4):
    """Sharded paths on an n_devices mesh, each against the same work on one
    device in this process. The sweeps use Rotosolve (angles only) on a
    small-angle ry/CX brickwall tape: the reference overlap stays O(1) and
    no angle's landscape is flat (an rz on a Z eigenstate would be), so every
    update is a unique sinusoid minimum and sharded and unsharded runs differ
    only by reduction-order noise."""
    import jax
    import jax.numpy as jnp
    from adaptaqc_tpu.backends import mps_core, sv_core
    from adaptaqc_tpu.circuits.tape import compile_tape
    from adaptaqc_tpu.ops import cplx
    from adaptaqc_tpu.optim import sweeps
    from adaptaqc_tpu.parallel import mesh as pmesh
    from adaptaqc_tpu.utils.constants import CMAP_LINEAR, generate_coupling_map
    from adaptaqc_tpu.utils.verification import cross_engine_overlap

    mesh = pmesh.make_mesh(n_devices)
    used = set(mesh.devices.flat)
    if used != set(jax.devices()[:n_devices]) or len(used) != n_devices:
        raise AssertionError(f"mesh {mesh.shape} uses {used}")
    log(f"[four] mesh {dict(mesh.shape)} over {sorted(d.id for d in used)}")
    one_mesh = pmesh.make_mesh(1, shape=(1, 1))

    def timed_twice(fn):
        t0 = time.time()
        fn()
        t1 = time.time()
        out = fn()
        return out, (t1 - t0, time.time() - t1)

    def compare(name, cost, cost0, rhos, rhos0, ang, ang0, times):
        dang = np.asarray(ang) - np.asarray(ang0)
        d = (abs(float(cost) - float(cost0)),
             float(np.abs(cplx.to_np(rhos) - cplx.to_np(rhos0)).max()),
             float(np.abs((dang + np.pi) % (2 * np.pi) - np.pi).max()))
        log(f"[four] {name}: cost {float(cost):.6f} vs one device "
            f"{float(cost0):.6f}; max |diff| cost {d[0]:.2e}, rho {d[1]:.2e},"
            f" angle {d[2]:.2e} (tol {FOUR_TOL:.0e}); first/second call "
            f"{times[0][0]:.1f}/{times[0][1]:.3f}s sharded, "
            f"{times[1][0]:.1f}/{times[1][1]:.3f}s one device")
        if not max(d) <= FOUR_TOL:
            raise AssertionError(f"{name}: sharded run disagrees with one "
                                 "device")

    # chi-sharded MPS step vs the same sweep + RDMs on one device
    tape = compile_tape(_brickwall(n_mps, 4, seed=1, angle=0.3, rz=False))
    step = pmesh.make_mps_training_step(mesh, n_mps, chi, tape.padded_length,
                                        rotoselect=False)
    engine = mps_core.sweep_engine(0.0, allow_env_cache=False)
    bl = sweeps.default_block_len(
        tape.padded_length,
        sweeps.state_nbytes(mps_core.zero_mps(n_mps, chi)))

    @jax.jit
    def one_device(prefix, ref, *tape_args):
        out = sweeps.sweep(engine, bl, False, prefix, ref, *tape_args)
        return out, mps_core.all_pair_rdms(out[3])

    def run_sharded():
        with mesh:
            return jax.block_until_ready(step(
                mps_core.zero_mps(n_mps, chi), tape, tape.trainable))

    def run_one():
        zero = mps_core.zero_mps(n_mps, chi)
        return jax.block_until_ready(one_device(
            zero, zero, jnp.asarray(tape.kinds), jnp.asarray(tape.q0),
            jnp.asarray(tape.q1), jnp.asarray(tape.angles),
            jnp.asarray(tape.trainable)))

    (_, na, cost, l_state, rhos, _), t_sh = timed_twice(run_sharded)
    ((_, na0, cost0, _, _, _), rhos0), t_one = timed_twice(run_one)
    devs = {s.device for s in l_state.b.re.addressable_shards}
    log(f"[four] MPS state bond axis on {len(devs)} devices")
    if len(devs) != n_devices:
        raise AssertionError("MPS state is not sharded over the mesh")
    compare(f"MPS step n={n_mps} chi={chi}", cost, cost0, rhos, rhos0, na,
            na0, (t_sh, t_one))

    # tp-sharded statevector step vs the same step on a one-device mesh
    stape = compile_tape(_brickwall(n_sv, 4, seed=3, angle=0.3, rz=False))
    pairs = np.asarray(generate_coupling_map(n_sv, CMAP_LINEAR), np.int32)

    def sv_runner(m):
        sv_step = pmesh.make_training_step(m, n_sv, stape.padded_length,
                                           rotoselect=False)

        def run():
            with m:
                return jax.block_until_ready(sv_step(
                    sv_core.zero_state(n_sv), stape, stape.trainable, pairs))
        return run

    (_, sna, scost, srhos, _), s_sh = timed_twice(sv_runner(mesh))
    (_, sna0, scost0, srhos0, _), s_one = timed_twice(sv_runner(one_mesh))
    compare(f"SV step n={n_sv}", scost, scost0, srhos, srhos0, sna, sna0,
            (s_sh, s_one))

    # MPSBackend(mesh=...) through AdaptCompiler vs the one-device compile;
    # the sharded solution is also re-simulated by the center-gauge engine
    qmps, res_one, _, w_one = run_compile(adapt_n, chi, adapt_layers)
    _, res_mesh, _, w_mesh = run_compile(adapt_n, chi, adapt_layers,
                                         mesh=mesh)
    check = cross_engine_overlap(qmps, res_mesh.circuit, chi=chi)
    d_ov = abs(res_mesh.overlap - res_one.overlap)
    d_chk = abs(check - res_mesh.overlap)
    log(f"[four] AdaptCompiler n={adapt_n} chi={chi} {adapt_layers} layers: "
        f"overlap {res_mesh.overlap:.6f} on the mesh vs {res_one.overlap:.6f}"
        f" on one device (|diff| {d_ov:.2e}), center-gauge check of the mesh "
        f"solution {check:.6f} (|diff| {d_chk:.2e}; tol {CROSS_TOL:.0e}); "
        f"pairs {res_mesh.qubit_pair_history} vs "
        f"{res_one.qubit_pair_history}; wall {w_mesh:.1f}s vs {w_one:.1f}s")
    if not (d_ov <= CROSS_TOL and d_chk <= CROSS_TOL):
        raise AssertionError("sharded AdaptCompiler disagrees with one device")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded-mesh phase")
    args = ap.parse_args(argv)
    _require_checkout()
    count = 4 if args.four else 1
    devs = _require_gpu(count)
    t0 = time.time()
    phase_device()
    smi = nvidia_smi()
    if args.four:
        phase_four()
    else:
        phase_kernels()
        phase_compile()
        phase_readme()
        phase_sweep(smi)
    log(f"[done] {time.time() - t0:.1f}s; card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    main()
