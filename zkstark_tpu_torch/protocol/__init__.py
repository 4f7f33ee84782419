from zkstark_tpu_torch.protocol.config import (
    STARK101,
    STARK101_Q3,
    STARK101_SECRET,
    StarkConfig,
    from_reference,
)
from zkstark_tpu_torch.protocol.proof import Proof
from zkstark_tpu_torch.protocol.prover import ProverArtifacts, prove, prove_pipelined
from zkstark_tpu_torch.protocol.verifier import VerificationError, VerifyReport, verify

__all__ = [
    "StarkConfig",
    "STARK101",
    "STARK101_Q3",
    "STARK101_SECRET",
    "from_reference",
    "Proof",
    "prove",
    "prove_pipelined",
    "ProverArtifacts",
    "verify",
    "VerificationError",
    "VerifyReport",
]
