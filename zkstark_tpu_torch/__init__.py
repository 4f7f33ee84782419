"""zkstark_tpu_torch — the STARK prover and verifier of `zkstark_tpu`, in
PyTorch with hand-written CUDA kernels for an NVIDIA H100.

Same protocol, same bytes: for the same configuration and witness, `prove`
returns the proof the JAX package returns, and each verifier accepts the
other's proofs. The SHA-256 leaf/node hashing, the NTT row transforms and
transposes, the Fiat-Shamir hash chain and the FRI fold run as CUDA C++
kernels on a CUDA device (`ops/`, sources in `csrc/`), and as plain-torch
twins on the CPU. This package imports neither JAX nor
`zkstark_tpu`.
"""

__version__ = "0.1.0"

from zkstark_tpu_torch.protocol import (
    STARK101,
    STARK101_SECRET,
    Proof,
    StarkConfig,
    VerificationError,
    prove,
    verify,
)

__all__ = [
    "prove",
    "verify",
    "StarkConfig",
    "STARK101",
    "STARK101_SECRET",
    "Proof",
    "VerificationError",
]
