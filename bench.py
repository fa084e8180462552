"""Benchmark: ADAPT-AQC hot-loop throughput on the paper workload scale.

Measures equivalent cost-evaluations/second of the Rotoselect sweep at the
reference's flagship scale (50-qubit MPS target, paper/random_mps workload;
/root/reference/examples/simple_mps_example.py runs 50 qubits). One
"equivalent cost evaluation" is what the reference performs per Rotosolve
probe: a full-circuit MPS simulation + overlap in Aer
(cost_minimiser.py:344-368 -> aer_mps_backend.py:49-78). Our sweep produces
the same sequential angle updates from cached environments, so evals/sec =
(probe evaluations implied by reference semantics) / wall-clock.

Also reports a FLOP model (chi^3 contraction/SVD counts per sweep, see
`sweep_flop_model`): achieved FLOP/s and its share of the card's published
f32 peak (PEAKS, keyed by device_kind) say how far the sweep sits from
speed-of-light. (XLA's cost_analysis is NOT used: it counts while/scan
bodies once, so it undercounts loop-heavy programs by the trip count.)

Runs on the GPU only: on any other platform it exits non-zero, and every
result names the platform, device_kind and device count.

Prints ONE JSON line to stdout; diagnostics go to stderr.
"""

import json
import os
import sys
import time

import numpy as np

# Published peaks by jax device_kind: dense rates without sparsity, at the
# card's full 700 W power limit.
PEAKS_SOURCE = "NVIDIA H100 Tensor Core GPU data sheet (SXM5)"
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12,
        "tf32_flops": 495e12,
        "fp32_flops": 67e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def build_workload(n, chi, window_layers):
    """(prefix MPS, ansatz tape, sweep callable pieces) for the paper-scale
    workload: a layered random-entangling 50q target + a window of
    thinly-dressed CNOT layers to Rotoselect over."""
    import jax
    import jax.numpy as jnp
    from adaptaqc_tpu.circuits.circuit import Circuit
    from adaptaqc_tpu.circuits.tape import compile_tape
    from adaptaqc_tpu.backends import mps_core
    from adaptaqc_tpu.optim import sweeps

    rng = np.random.default_rng(0)
    target = Circuit(n)
    for q in range(n):
        target.ry(float(rng.uniform(-3, 3)), q)
    for layer in range(3):
        for q in range(layer % 2, n - 1, 2):
            target.cx(q, q + 1)
        for q in range(n):
            target.rz(float(rng.uniform(-3, 3)), q)
    ttape = compile_tape(target)
    t0 = time.time()
    prefix = mps_core.apply_tape(mps_core.zero_mps(n, chi),
                                 jnp.asarray(ttape.kinds),
                                 jnp.asarray(ttape.q0),
                                 jnp.asarray(ttape.q1),
                                 jnp.asarray(ttape.angles), 1e-16)
    jax.block_until_ready(prefix.lam)
    log(f"target MPS build: {time.time() - t0:.1f}s "
        f"({ttape.length} gates, incl. compile)")

    ansatz = Circuit(n)
    for _ in range(window_layers):
        a = int(rng.integers(n - 1))
        ansatz.rz(0.1, a)
        ansatz.rz(0.1, a + 1)
        ansatz.cx(a, a + 1)
        ansatz.rz(0.1, a)
        ansatz.rz(0.1, a + 1)
    atape = compile_tape(ansatz)
    engine = mps_core.sweep_engine(1e-16)
    ref = mps_core.zero_mps(n, chi)
    bl = sweeps.default_block_len(atape.padded_length,
                                  sweeps.state_nbytes(ref))
    return prefix, ref, engine, bl, atape


def sweep_flop_model(n, chi, tape, single_block=False):
    """Real-FLOP count of one Rotoselect sweep over `tape` at bond dim chi.

    Conventions: a complex GEMM (m,k)x(k,n) in split-complex form is 4 real
    GEMMs = 8mkn real FLOPs. Dominant terms per sweep (optim/sweeps.py):

    - gate applies: every tape gate is applied 3x (backward checkpoint
      pass + per-block right-state regeneration + forward apply), or 2x
      when the whole tape fits one block (phase A skipped). A 2q
      apply (mps_core._apply_2q_adjacent) costs
        theta build        8*(2chi*chi*2chi)        = 32 chi^3
        theta^H theta      8*(2chi)^3               = 64 chi^3
        eigh of 4chi embed ~9*(4chi)^3              = 576 chi^3
        U = theta V        8*(2chi*2chi*chi)        = 32 chi^3
        Gram-Schmidt scan  ~24 chi^3
      ~ 728 chi^3 real FLOPs; 1q applies are O(chi^2), ignored.
    - probes: each trainable rotation probes the 2x2 local overlap matrix
      (mps_core.local_overlap_matrix): prefix + suffix transfer scans over
      all n sites, each site 2 physical x 2 complex GEMMs (chi,chi)^3
      = 32 chi^3 -> 64 n chi^3 per probe.
    """
    from adaptaqc_tpu.circuits import gates as G
    kinds = np.asarray(tape.kinds)
    n_2q = int(np.sum((kinds == G.CX) | (kinds == G.CZ) | (kinds == G.SWAP)
                      | (kinds >= G.N_KINDS)))
    n_rot = int(np.sum(np.asarray(tape.trainable)))
    passes = 2 if single_block else 3  # single-block sweeps skip phase A
    apply_flops = passes * n_2q * 728 * chi ** 3
    probe_flops = n_rot * 64 * n * chi ** 3
    return float(apply_flops + probe_flops)


def run_sweep_benchmark(n, chi, window_layers, iters):
    """Returns (evals_per_sec, evals_per_sweep, dt_seconds, flops_per_sweep)."""
    import jax
    import jax.numpy as jnp
    from adaptaqc_tpu.optim import sweeps

    prefix, ref, engine, bl, atape = build_workload(n, chi, window_layers)
    q0, q1 = jnp.asarray(atape.q0), jnp.asarray(atape.q1)
    sel = jnp.asarray(atape.trainable)
    kinds, angles = jnp.asarray(atape.kinds), jnp.asarray(atape.angles)

    flops_per_sweep = sweep_flop_model(n, chi, atape,
                                       single_block=(bl >= atape.padded_length))

    # production sweeps run as ONE fused device program
    # (sweep_until_converged); measure the same shape here — per-call host
    # latency would otherwise dominate and understate device throughput
    t0 = time.time()
    out = sweeps.sweep(engine, bl, True, prefix, ref, kinds, q0, q1, angles,
                       sel)
    jax.block_until_ready(out[2])
    log(f"first sweep (incl. compile): {time.time() - t0:.1f}s")
    evals_per_sweep = int(out[4])

    fused = sweeps.sweep_n_cycles
    out2 = fused(engine, bl, True, iters, prefix, ref, kinds, q0, q1,
                 angles, sel)
    jax.block_until_ready(out2[2])  # compile the fused loop
    t0 = time.time()
    out2 = fused(engine, bl, True, iters, prefix, ref, out2[0], q0, q1,
                 out2[1], sel)
    jax.block_until_ready(out2[2])
    dt = (time.time() - t0) / iters
    log(f"steady sweep (fused x{iters}): {dt * 1e3:.2f} ms/sweep, "
        f"{evals_per_sweep} equivalent evals/sweep, "
        f"cost {float(out2[2]):.6f}")
    return evals_per_sweep / dt, evals_per_sweep, dt, flops_per_sweep


def device_peaks(device_kind: str) -> dict:
    """Published peaks of the device this run is on. A device that is not in
    PEAKS is an error: a rate is never divided by a guessed peak."""
    if device_kind not in PEAKS:
        raise KeyError(f"no published peaks for device kind {device_kind!r}; "
                       f"known: {sorted(PEAKS)}")
    return PEAKS[device_kind]


def main():
    import jax
    from chip_smoke import nvidia_smi
    dev = jax.devices()[0]
    device = {"platform": dev.platform, "device_kind": dev.device_kind,
              "device_count": len(jax.devices())}
    if device["platform"] != "gpu":
        raise SystemExit(f"bench.py measures the GPU; found {device} "
                         "(no CPU fallback)")

    n = int(os.environ.get("BENCH_N", 50))
    chi = int(os.environ.get("BENCH_CHI", 64))
    window_layers = int(os.environ.get("BENCH_LAYERS", 12))
    iters = int(os.environ.get("BENCH_ITERS", 10))
    peaks = device_peaks(device["device_kind"])
    log(f"bench: n={n} chi={chi} devices={jax.devices()}")

    evals_per_sec, evals_per_sweep, dt, flops = run_sweep_benchmark(
        n, chi, window_layers, iters)

    from adaptaqc_tpu.ops import cplx
    achieved = flops / dt
    record = {
        "metric": "overlap_cost_evals_per_sec_50q_mps",
        "value": evals_per_sec,
        "unit": "equivalent cost evaluations / second (n=%d, chi=%d)"
                % (n, chi),
        "ms_per_sweep": dt * 1e3,
        "evals_per_sweep": evals_per_sweep,
        "eigh_impl": cplx._eigh_impl(),
        "flops_per_sweep": flops,
        "achieved_tflops": achieved / 1e12,
        # the sweep's matmuls are f32 at Precision.HIGHEST (no tensor-core
        # TF32), so the f32 peak is the relevant bound
        "flop_share_of_fp32_peak": achieved / peaks["fp32_flops"],
        "peak_source": PEAKS_SOURCE,
        # name and power limit: a card set below 700 W runs slower
        "card": nvidia_smi(),
        **device,
    }
    print(json.dumps(record))


if __name__ == "__main__":
    main()
