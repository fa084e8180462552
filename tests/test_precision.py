"""Every floating-point dot on a device path asks for Precision.HIGHEST.

A default-precision f32 product may run in reduced precision on an
accelerator (TF32 on a GPU keeps ~3 decimal digits), while 50-qubit compiles
start near overlap 1e-6. These tests trace the device programs and walk every
nested jaxpr (scans, conds, while loops) for dot_general equations.
"""

import jax
import jax.extend.core as jcore
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

from adaptaqc_tpu.backends import mps_core, sv_core
from adaptaqc_tpu.circuits.circuit import Circuit
from adaptaqc_tpu.circuits.tape import compile_tape
from adaptaqc_tpu.ops import cplx
from adaptaqc_tpu.optim import sweeps

HI = lax.Precision.HIGHEST


def _subjaxprs(value):
    if isinstance(value, jcore.ClosedJaxpr):
        yield value.jaxpr
    elif isinstance(value, jcore.Jaxpr):
        yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _subjaxprs(v)


def float_dots(jaxpr):
    """(precision, operand dtypes) of every floating dot_general."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            dts = tuple(v.aval.dtype for v in eqn.invars)
            if all(jnp.issubdtype(d, jnp.floating) for d in dts):
                out.append((eqn.params["precision"], dts))
        for value in eqn.params.values():
            for sub in _subjaxprs(value):
                out.extend(float_dots(sub))
    return out


def _tape(n, depth=3, seed=0):
    rng = np.random.default_rng(seed)
    qc = Circuit(n)
    for _ in range(depth):
        a = int(rng.integers(n - 1))
        qc.rz(0.1, a)
        qc.ry(0.2, a + 1)
        qc.cx(a, a + 1)
    return compile_tape(qc)


def _sweep_program(engine, prefix, ref, tape):
    args = (prefix, ref, jnp.asarray(tape.kinds), jnp.asarray(tape.q0),
            jnp.asarray(tape.q1), jnp.asarray(tape.angles, jnp.float32),
            jnp.asarray(tape.trainable))
    bl = sweeps.default_block_len(tape.padded_length)
    return jax.make_jaxpr(
        lambda *a: sweeps.sweep(engine, bl, True, *a))(*args)


def _programs():
    n, chi, dt = 5, 16, jnp.float32
    st = mps_core.zero_mps(n, chi, dt)
    tape = _tape(n)
    pairs = jnp.asarray([[0, 1], [1, 2]], jnp.int32)
    ops = cplx.zeros((2, 1, 2, 2), dt)
    return {
        "mps_sweep": lambda: _sweep_program(
            mps_core.sweep_engine(1e-10), st, st, tape),
        "sv_sweep": lambda: _sweep_program(
            sv_core.sweep_engine(), sv_core.zero_state(n, dt),
            sv_core.zero_state(n, dt), tape),
        "probe_chain": lambda: jax.make_jaxpr(
            mps_core.local_overlap_matrix)(st, st, jnp.int32(2)),
        "all_pair_rdms": lambda: jax.make_jaxpr(mps_core.all_pair_rdms)(st),
        "pair_op_overlaps": lambda: jax.make_jaxpr(
            lambda a, b, x, y, p: mps_core.pair_op_overlaps(a, b, x, y, p, 1))(
                st, st, ops, ops, pairs),
    }


@pytest.mark.parametrize("name", ["mps_sweep", "sv_sweep", "probe_chain",
                                  "all_pair_rdms", "pair_op_overlaps"])
def test_device_dots_ask_for_highest(name):
    dots = float_dots(_programs()[name]().jaxpr)
    # the statevector engine applies gates by gather + elementwise math and
    # has no dot at all; every MPS program must show some
    assert dots or name == "sv_sweep", f"{name}: the walk found no dot"
    low = [(p, d) for p, d in dots
           if not (isinstance(p, tuple) and all(x == HI for x in p))]
    assert not low, f"{name}: {len(low)} dots below HIGHEST: {low[:3]}"
