"""adaptaqc_tpu: ADAPT-AQC in JAX (Adaptive Approximate Quantum Compiling).

A from-scratch JAX/XLA re-design of qiskit-community/adapt-aqc: compile a
target quantum state (circuit or MPS) into a shallow two-qubit-gate circuit by
adaptively growing an ansatz, with all simulation (statevector and MPS
engines), Rotosolve/Rotoselect optimisation, and pair-selection heuristics
running as batched on-device XLA programs.
"""

from .compilers import AdaptCompiler, AdaptConfig, AdaptResult
from .compilers.approximate_compiler import (ApproximateCompiler,
                                             CompileInPartsResult)
from .backends.backend import (AQCBackend, CenterMPSBackend, MPSBackend,
                               SamplingBackend, SVBackend,
                               mps_backend_with_args,
                               MPS_SIM, QASM_SIM, SV_SIM, CENTER_MPS_SIM)
from .circuits.circuit import Circuit

__version__ = "0.1.0"

__all__ = [
    "AdaptCompiler", "AdaptConfig", "AdaptResult", "ApproximateCompiler",
    "CompileInPartsResult", "AQCBackend", "CenterMPSBackend", "MPSBackend",
    "SamplingBackend",
    "SVBackend", "mps_backend_with_args", "MPS_SIM", "QASM_SIM", "SV_SIM",
    "CENTER_MPS_SIM", "Circuit",
]
