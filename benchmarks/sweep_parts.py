"""Where the n=50 Rotoselect sweep's time goes on the card, by part.

For chi in {32, 64, 128}: one probe contraction (the transfer-environment
chains, mps_core.local_overlap_matrix), the eigh step of svd_trunc on a
full-rank Gram matrix under both eigh paths (ADAPTAQC_EIGH=embed|tridiag),
one whole 2q apply under both, and bench.py's whole fused sweep under both
(timed twice each, in turns). Shares follow from the per-sweep counts of
probes and 2q applies. Every line printed names the card; JSON records also
go to chiprun_out/sweep_parts.jsonl.

Usage: python benchmarks/sweep_parts.py [chi ...]
"""

import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

N = 50
WINDOW_LAYERS = 12
SWEEP_ITERS = 10


def _timed(fn, *args, reps=3):
    """Best-of-reps seconds of fn(*args) (already compiled) to completion."""
    import jax
    best = None
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return best


def probe_seconds(chi):
    """Seconds per probe contraction: n-1 probes at q = 0..n-2 in one jit."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from adaptaqc_tpu.backends import mps_core
    from adaptaqc_tpu.ops.cplx import C
    rng = np.random.default_rng(0)
    sigma = (2.0 ** -0.5 / chi) ** 0.5  # keeps the chain's norm O(1)

    def sites():
        shape = (N, 2, chi, chi)
        return C(jnp.asarray(rng.normal(0, sigma, shape), jnp.float32),
                 jnp.asarray(rng.normal(0, sigma, shape), jnp.float32))

    lam = jnp.ones((N + 1, chi), jnp.float32)
    r = mps_core.MPS(sites(), lam, jnp.float32(0))
    l = mps_core.MPS(sites(), lam, jnp.float32(0))

    @jax.jit
    def run(acc):
        return lax.fori_loop(
            0, N - 1,
            lambda q, a: a + mps_core.local_overlap_matrix(r, l, q).re, acc)

    acc = jnp.zeros((2, 2), jnp.float32)
    jax.block_until_ready(run(acc))
    return _timed(run, acc) / (N - 1)


def eigh_seconds(chi, impl, reps=32):
    """Seconds per eigh_top of a (2chi)^2 Gram matrix under `impl`."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from adaptaqc_tpu.ops import cplx
    rng = np.random.default_rng(1)
    a = (rng.standard_normal((2 * chi, 2 * chi))
         + 1j * rng.standard_normal((2 * chi, 2 * chi)))
    h = cplx.from_np(a.conj().T @ a)
    fn = cplx.eigh_top if impl == "embed" else cplx.eigh_top_tridiag

    @jax.jit
    def run(h):
        def body(i, carry):  # the carry chains the calls in order
            w, _ = fn(cplx.C(h.re + carry, h.im), chi)
            return carry + 1e-30 * w[0]
        return lax.fori_loop(0, reps, body, jnp.float32(0))

    jax.block_until_ready(run(h))
    return _timed(run, h) / reps


def apply_seconds(chi, reps=64):
    """Seconds per 2q apply (theta, Gram, eigh, extraction, new tensors),
    walking the bonds of a state grown from |0> by the applies themselves
    (low-rank Grams early on, as in a compile)."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from adaptaqc_tpu.backends import mps_core
    from adaptaqc_tpu.ops import cplx
    rng = np.random.default_rng(2)
    q, _ = np.linalg.qr(rng.standard_normal((4, 4))
                        + 1j * rng.standard_normal((4, 4)))
    u4 = cplx.from_np(q)

    @jax.jit
    def run(st):
        return lax.fori_loop(
            0, reps, lambda i, s: mps_core._apply_2q_adjacent(
                s, u4, i % (N - 1), 1e-8), st)

    st = jax.block_until_ready(run(mps_core.zero_mps(N, chi, jnp.float32)))
    return _timed(run, st) / reps


def sweep_timer(chi):
    """(compiled sweep callable, applies/sweep, probes/sweep, evals/sweep)
    for bench.py's workload under the current eigh path."""
    import jax
    import jax.numpy as jnp
    from bench import build_workload
    from adaptaqc_tpu.circuits import gates as G
    from adaptaqc_tpu.optim import sweeps
    prefix, ref, engine, bl, atape = build_workload(N, chi, WINDOW_LAYERS)
    args = (prefix, ref, jnp.asarray(atape.kinds), jnp.asarray(atape.q0),
            jnp.asarray(atape.q1), jnp.asarray(atape.angles),
            jnp.asarray(atape.trainable))
    out = sweeps.sweep_n_cycles(engine, bl, True, SWEEP_ITERS, *args)
    jax.block_until_ready(out[2])
    kinds = np.asarray(atape.kinds)
    n_2q = int(np.sum((kinds == G.CX) | (kinds == G.CZ) | (kinds == G.SWAP)
                      | (kinds >= G.N_KINDS)))
    passes = 2 if bl >= atape.padded_length else 3
    n_rot = int(np.sum(np.asarray(atape.trainable)))
    evals = int(sweeps.sweep(engine, bl, True, *args)[4])

    def run():
        return sweeps.sweep_n_cycles(engine, bl, True, SWEEP_ITERS, *args)[2]

    return run, passes * n_2q, n_rot, evals


def emit(rec, sink):
    print(json.dumps(rec), flush=True)
    sink.write(json.dumps(rec) + "\n")
    sink.flush()


def main():
    import jax
    from chip_smoke import nvidia_smi
    from adaptaqc_tpu.ops import cplx
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"sweep_parts.py times the GPU; found {dev.platform}")
    chis = [int(c) for c in sys.argv[1:]] or [32, 64, 128]
    out_dir = os.path.join(os.path.dirname(HERE), "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "sweep_parts.jsonl"), "a") as sink:
        base = {"device_kind": dev.device_kind, "card": nvidia_smi(),
                "n": N}
        for chi in chis:
            emit({**base, "what": "probe", "chi": chi,
                  "ms": probe_seconds(chi) * 1e3}, sink)
            for impl in cplx.EIGH_IMPLS:
                emit({**base, "what": "eigh_top_full_rank", "chi": chi,
                      "impl": impl, "ms": eigh_seconds(chi, impl) * 1e3}, sink)
        runs = {}
        for impl in cplx.EIGH_IMPLS:
            cplx.set_eigh_impl(impl)  # clears the jit caches
            for chi in chis:
                emit({**base, "what": "apply_2q", "chi": chi, "impl": impl,
                      "ms": apply_seconds(chi) * 1e3}, sink)
                t0 = time.perf_counter()
                runs[impl, chi] = sweep_timer(chi)
                emit({**base, "what": "sweep_compile", "chi": chi,
                      "impl": impl, "s": time.perf_counter() - t0}, sink)
                run = runs[impl, chi][0]
                runs[impl, chi] += ([_timed(run, reps=1) / SWEEP_ITERS
                                     for _ in range(2)],)
        cplx.set_eigh_impl("")
        for (impl, chi), (_, applies, probes, evals, times) in runs.items():
            ms = [t * 1e3 for t in times]
            emit({**base, "what": "sweep", "chi": chi, "impl": impl,
                  "ms_per_sweep": ms, "applies_per_sweep": applies,
                  "probes_per_sweep": probes, "evals_per_sweep": evals,
                  "evals_per_s": evals / (min(ms) / 1e3)}, sink)


if __name__ == "__main__":
    main()
