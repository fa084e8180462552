"""A/B: standard fused sweep cycles vs zigzag cycle pairs on the bench
workload (n=50 chi=64 by default). Reports ms per UPDATE CYCLE for each
mode — zigzag pays (2P+1)G applies for 2P cycles vs the standard 4PG.

Usage: python benchmarks/zigzag_ab.py
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    import jax.numpy as jnp
    from bench import build_workload
    from adaptaqc_tpu.optim import sweeps

    n = int(os.environ.get("BENCH_N", 50))
    chi = int(os.environ.get("BENCH_CHI", 64))
    layers = int(os.environ.get("BENCH_LAYERS", 12))
    pairs = 5  # 10 update cycles each mode

    prefix, ref, engine, bl, tape = build_workload(n, chi, layers)
    kinds, angles = jnp.asarray(tape.kinds), jnp.asarray(tape.angles)
    q0, q1 = jnp.asarray(tape.q0), jnp.asarray(tape.q1)
    sel = jnp.asarray(tape.trainable)

    # Vary the angles on every call and measure the SLOPE between a small
    # and a large cycle count, so a fixed per-call cost cancels out.
    import numpy as np
    rng = np.random.default_rng(0)

    def jitter():
        return angles + jnp.asarray(
            rng.uniform(-1e-4, 1e-4, angles.shape), angles.dtype)

    def run_std(cycles):
        out = sweeps.sweep_n_cycles(engine, bl, True, cycles, prefix, ref,
                                    kinds, q0, q1, jitter(), sel)
        jax.block_until_ready(out[2])
        return out

    def run_zz(cycle_pairs):
        out = sweeps.sweep_zigzag_n_cycles(engine, True, cycle_pairs, prefix,
                                           ref, kinds, q0, q1, jitter(), sel)
        jax.block_until_ready(out[2])
        return out

    results = {}
    reps = 3
    for name, fn, sizes in [("standard", run_std, (2, 2 * pairs + 2)),
                            ("zigzag", run_zz, (1, pairs + 1))]:
        times = []
        for size in sizes:
            fn(size)  # compile this cycle-count bucket
            t0 = time.time()
            for _ in range(reps):
                out = fn(size)
            times.append((time.time() - t0) / reps)
        per_cycle = (times[1] - times[0]) / (2 * pairs) * 1e3
        results[name] = round(per_cycle, 2)
        print(f"{name}: {per_cycle:.2f} ms/update-cycle "
              f"(cost {float(out[2]):.6f}, evals {int(out[3])})",
              file=sys.stderr)
    results["speedup"] = round(results["standard"] / results["zigzag"], 3)
    print(json.dumps({"bench": "zigzag_ab", "n": n, "chi": chi, **results}))


if __name__ == "__main__":
    main()
