"""ctypes binding to the independent C++ verifier and the Fiat-Shamir channel
primitives of ``native/zkstark_native.cpp`` — counterpart of
``zkstark_tpu/native.py``.

At first use, ``g++ -O3 -fPIC -shared`` builds the repository's
``native/zkstark_native.cpp`` into ``build/zkstark_tpu_torch/`` under the
repository root (named by a hash of the source; ``native/`` is only read).
A missing compiler or a failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

from zkstark_tpu_torch.ops._build import gxx

SRC = Path(__file__).resolve().parents[1] / "native" / "zkstark_native.cpp"


@functools.lru_cache(maxsize=1)
def native() -> ctypes.CDLL:
    """The loaded C++ library, built first if needed."""
    lib = ctypes.CDLL(str(gxx(SRC, "libzkstark_native")))
    lib.zk_verify.argtypes = [
        ctypes.c_char_p,  # final state (32)
        ctypes.c_char_p,  # transcript
        ctypes.c_size_t,
        ctypes.c_uint32,  # trace_len
        ctypes.c_uint32,  # blowup
        ctypes.c_uint32,  # coset_offset
        ctypes.c_uint32,  # n_queries
        ctypes.c_uint32,  # prime
        ctypes.POINTER(ctypes.c_uint32),  # AIR description blob
        ctypes.c_size_t,  # blob length (u32 words)
        ctypes.c_char_p,  # error buffer
        ctypes.c_size_t,
    ]
    lib.zk_verify.restype = ctypes.c_int
    lib.zk_channel_commit.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t]
    lib.zk_channel_commit.restype = None
    lib.zk_channel_draw.argtypes = [ctypes.c_char_p]
    lib.zk_channel_draw.restype = ctypes.c_uint32
    return lib


def channel_commit(state: bytes, payload: bytes) -> bytes:
    """The channel state after committing `payload`: SHA256(state ‖ payload)."""
    buf = ctypes.create_string_buffer(state, 32)
    native().zk_channel_commit(buf, payload, len(payload))
    return buf.raw[:32]


def channel_draw(state: bytes) -> tuple:
    """(the state after the draw, the drawn u32) of one channel draw."""
    buf = ctypes.create_string_buffer(state, 32)
    draw = native().zk_channel_draw(buf)
    return buf.raw[:32], int(draw)


def verify_native(proof, cfg) -> None:
    """Raise VerificationError if the C++ verifier rejects the proof. The
    constraint system travels as the serialized AIR (air.serialize_air).
    The C++ verifier folds log2(trace domain) FRI rounds; a config with
    other rounds (an AIR of degree above 2, ``config.py`` `fri_rounds`), or
    a trace of more than one column, raises ValueError instead of being
    rejected there."""
    from zkstark_tpu_torch.protocol.air import serialize_air
    from zkstark_tpu_torch.protocol.prover import require_one_column
    from zkstark_tpu_torch.protocol.verifier import VerificationError

    require_one_column(cfg, "verify_native")
    if cfg.fri_rounds != cfg.trace_domain.bit_length() - 1:
        raise ValueError(
            f"verify_native: the {cfg.air.name!r} AIR folds {cfg.fri_rounds} FRI rounds; "
            f"the C++ verifier folds log2(trace domain) = {cfg.trace_domain.bit_length() - 1}"
        )
    lib = native()
    blob = serialize_air(cfg)
    err = ctypes.create_string_buffer(256)
    rc = lib.zk_verify(
        proof.state,
        proof.data,
        len(proof.data),
        cfg.trace_len,
        cfg.blowup,
        cfg.coset_offset,
        cfg.n_queries,
        cfg.field.p,
        blob.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        len(blob),
        err,
        len(err),
    )
    if rc != 0:
        raise VerificationError(f"native(code={rc})", err.value.decode())
