"""Shared benchmark-record helpers.

Imported at module top by the harnesses so that nothing new is imported at
record-write time: a multi-hour compile must never lose its record to a
mid-edit import or a serialisation error (this happened once — see the
recovered seed-65 record).
"""
import gzip
import os
import subprocess
import time

CIRCUITS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "circuits")


def git_rev():
    """Engine build identifier for benchmark records (trajectories are
    chaotically sensitive to f32-level engine changes, so records must say
    which build produced them)."""
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            capture_output=True, text=True, timeout=10).stdout.strip() or None
    except Exception:
        return None


def platform():
    """Which jax backend produced a record. Never raises."""
    try:
        import jax
        return jax.default_backend()
    except Exception:
        return None


def save_circuit(result, name_prefix):
    """Persist the compiled circuit (QASM already rendered on the result —
    adapt_compiler stores result.circuit_qasm at compile end) so any record
    can be re-simulated later. Never raises: returns the repo-relative path
    or None."""
    try:
        text = getattr(result, "circuit_qasm", None)
        if not text:
            from adaptaqc_tpu.circuits import qasm
            text = qasm.dumps(result.circuit)
        os.makedirs(CIRCUITS_DIR, exist_ok=True)
        name = f"{name_prefix}_{int(time.time())}.qasm.gz"
        with gzip.open(os.path.join(CIRCUITS_DIR, name), "wt") as f:
            f.write(text)
        return f"circuits/{name}"
    except Exception:
        return None


def compile_with_recovery(compiler, tag, **compile_kwargs):
    """compiler.compile(**kwargs) with cross-process crash recovery.

    A killed process loses a multi-minute compile with nothing to show, and
    a dead PJRT client cannot be rebuilt in-process, so recovery is
    cross-process: checkpoint the whole
    compiler every BENCH_CHECKPOINT_EVERY layers (default 50; 0 disables)
    into benchmarks/checkpoints/<tag>/, and on a FRESH start resume from
    the newest checkpoint if one exists (the framework's pickle codec +
    resume path, io/checkpoint.py, proven by
    tests/test_oracles.py::TestCheckpointResumeEquality). The directory is
    removed on success, so a later run of the same tag starts clean.

    Returns (compiler, result) — on resume the caller must use the
    RETURNED compiler (the pickled object replaces the one passed in)."""
    import glob
    import pickle
    import shutil
    import sys

    every = int(os.environ.get("BENCH_CHECKPOINT_EVERY", "50"))
    if every <= 0:
        return compiler, compiler.compile(**compile_kwargs)
    ckdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "checkpoints", tag)
    os.makedirs(ckdir, exist_ok=True)
    pkls = glob.glob(os.path.join(ckdir, "*.pkl"))
    if pkls:
        newest = max(pkls, key=lambda p: int(os.path.basename(p)[:-4]))
        print(f"resuming {tag} from checkpoint {newest}", file=sys.stderr,
              flush=True)
        with open(newest, "rb") as f:
            compiler = pickle.load(f)
        # a resumed compile ignores initial_ansatz / optimise flags (they
        # are baked into the pickled state); keep checkpointing
        result = compiler.compile(checkpoint_every=every,
                                  checkpoint_dir=ckdir,
                                  delete_prev_chkpt=True)
    else:
        result = compiler.compile(checkpoint_every=every,
                                  checkpoint_dir=ckdir,
                                  delete_prev_chkpt=True, **compile_kwargs)
    shutil.rmtree(ckdir, ignore_errors=True)
    return compiler, result
