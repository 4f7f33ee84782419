"""Checkpoint / resume at Fiat-Shamir barriers — counterpart of
``zkstark_tpu/protocol/checkpoint.py``.

After each barrier the transcript prefix fixes every later challenge, so a
proof resumes from (channel, arrays so far) with no phase recomputed, on any
device: a checkpoint written on the card resumes on the CPU to the same
bytes. The barriers keep the JAX phase names:

  phase1, phase2, fri   the host-synced phases (`ResumableProver(fused=False)`);
  fused                 after all device work (`prover.device_phases`): only
                        the host decommit is left. The CLI's ``--checkpoint``
                        writes this one.

A checkpoint is an .npz of host numpy arrays plus the channel state, the
transcript, a statement fingerprint, an explicit format version and a
SHA-256 integrity digest over all of it. Saves are atomic (temp file +
``os.replace``). Loading raises `CheckpointVersionError` for another format
version, `CheckpointKeyError` for a missing entry, and `CheckpointError` for
an unreadable file, a failed digest or another statement.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
import zipfile

import numpy as np

from zkstark_tpu_torch.field import fp
from zkstark_tpu_torch.hash import merkle
from zkstark_tpu_torch.protocol import prover as pr
from zkstark_tpu_torch.protocol.config import StarkConfig
from zkstark_tpu_torch.protocol.proof import Proof
from zkstark_tpu_torch.transcript import Channel

FORMAT_VERSION = 1
_HEADER = ("__phase__", "__state__", "__data__", "__fp__", "__check__")
# the arrays each barrier (each of `ResumableProver.PHASES` but "done") leaves
# for the phases after it
PHASE_KEYS = {
    "phase1": ("f_eval", "f_res", "f_levels"),
    "phase2": ("f_res", "f_levels", "cp_eval", "layer_res", "layer_levels"),
    "fri": ("f_res", "f_levels", "layer_res", "layer_levels"),
    "fused": (
        "open_f_vals",
        "open_f_paths",
        "open_cp_vals",
        "open_cp_paths",
        "open_fri_vals",
        "open_fri_paths",
        "queries_drawn",
    ),
}


class CheckpointError(RuntimeError):
    pass


class CheckpointVersionError(CheckpointError):
    """The file has no format version, or another one than FORMAT_VERSION."""


class CheckpointKeyError(CheckpointError):
    """An entry the checkpoint format or its phase needs is missing."""


def _flatten(arrays: dict) -> dict:
    """dict of (array | list[array] | list[list[array]]) → flat npz-able dict."""
    flat = {}
    for key, val in arrays.items():
        if isinstance(val, (list, tuple)):
            flat[f"__len__{key}"] = np.int64(len(val))
            for i, item in enumerate(val):
                flat.update(_flatten({f"{key}__{i}": item}))
        else:
            flat[key] = np.asarray(val)
    return flat


def _unflatten(flat: dict) -> dict:
    def build(key):
        lkey = f"__len__{key}"
        if lkey in flat:
            return [build(f"{key}__{i}") for i in range(int(flat[lkey]))]
        return flat[key]

    tops = set()
    for k in flat:
        name = k[len("__len__"):] if k.startswith("__len__") else k
        tops.add(name.split("__")[0])
    return {t: build(t) for t in sorted(tops)}


def statement_fingerprint(cfg: StarkConfig, secret: int) -> bytes:
    """Binds a checkpoint to its statement: every config field and the
    witness seed, so a resume with another --secret, --trace-len, --air or
    --prime refuses instead of finishing the old proof."""
    h = hashlib.sha256()
    h.update(b"zkstark-torch-checkpoint|")
    fields = (
        cfg.trace_len,
        cfg.blowup,
        cfg.coset_offset,
        cfg.boundary_first,
        cfg.boundary_last,
        cfg.n_queries,
        cfg.air.name,
        cfg.field.p,
        int(secret),
    )
    h.update("|".join(map(str, fields)).encode())
    return h.digest()


def _digest(phase: str, state: bytes, data: bytes, flat: dict, fingerprint: bytes) -> bytes:
    """SHA-256 over the version, fingerprint, phase, channel state,
    transcript and every array's key, shape, dtype and raw bytes."""
    h = hashlib.sha256()
    h.update(f"v{FORMAT_VERSION}|".encode())
    h.update(fingerprint)
    h.update(phase.encode())
    h.update(state)
    h.update(data)
    for key in sorted(flat):
        arr = np.ascontiguousarray(flat[key])
        h.update(key.encode())
        h.update(str(arr.shape).encode())
        h.update(str(arr.dtype).encode())
        h.update(arr.tobytes())
    return h.digest()


def save(path: str, phase: str, channel: Channel, arrays: dict, fingerprint: bytes = b"") -> None:
    """Write a checkpoint atomically; `arrays` holds host numpy arrays (or
    lists of them)."""
    flat = _flatten(arrays)
    state, data = channel.state, bytes(channel.data)
    check = _digest(phase, state, data, flat, fingerprint)
    flat["__version__"] = np.int64(FORMAT_VERSION)
    flat["__phase__"] = np.frombuffer(phase.encode(), dtype=np.uint8)
    flat["__state__"] = np.frombuffer(state, dtype=np.uint8)
    flat["__data__"] = np.frombuffer(data, dtype=np.uint8)
    flat["__fp__"] = np.frombuffer(fingerprint, dtype=np.uint8)
    flat["__check__"] = np.frombuffer(check, dtype=np.uint8)
    fd, tmp = tempfile.mkstemp(
        dir=os.path.dirname(os.path.abspath(path)) or ".", suffix=".npz.tmp"
    )
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load(path: str, fingerprint: bytes | None = None):
    """→ (phase, channel, arrays of host numpy). With `fingerprint`, a
    checkpoint of another statement is refused."""
    try:
        with np.load(path) as z:
            flat = {k: z[k] for k in z.files}
    except (OSError, ValueError, EOFError, zipfile.BadZipFile) as e:
        raise CheckpointError(f"unreadable checkpoint {path!r}: {e}") from e
    if "__version__" not in flat:
        raise CheckpointVersionError(f"checkpoint {path!r} has no format version")
    version = int(flat.pop("__version__"))
    if version != FORMAT_VERSION:
        raise CheckpointVersionError(
            f"checkpoint {path!r} has format version {version}, this program reads {FORMAT_VERSION}"
        )
    for key in _HEADER:
        if key not in flat:
            raise CheckpointKeyError(f"checkpoint {path!r} has no entry {key!r}")
    phase = flat.pop("__phase__").tobytes().decode(errors="replace")
    state = flat.pop("__state__").tobytes()
    data = flat.pop("__data__").tobytes()
    stored_fp = flat.pop("__fp__").tobytes()
    check = flat.pop("__check__").tobytes()
    if phase not in PHASE_KEYS:
        raise CheckpointError(f"checkpoint {path!r} has unknown phase {phase!r}")
    for key in PHASE_KEYS[phase]:
        if key not in flat and f"__len__{key}" not in flat:
            raise CheckpointKeyError(f"{phase} checkpoint {path!r} has no entry {key!r}")
    if _digest(phase, state, data, flat, stored_fp) != check:
        raise CheckpointError("checkpoint integrity check failed")
    if fingerprint is not None and stored_fp != fingerprint:
        raise CheckpointError(
            f"checkpoint {path!r} was created for a DIFFERENT statement "
            "(config or witness changed since it was written) — refusing to "
            "resume; delete the file to start over"
        )
    ch = Channel()
    ch.state = state
    ch.data = bytearray(data)
    return phase, ch, _unflatten(flat)


def _host_levels(levels: list) -> list:
    return [fp.to_host(lv) for lv in levels]


class ResumableProver:
    """The prover as a phase state machine with a checkpoint written at each
    Fiat-Shamir barrier.

    fused=True: one checkpoint after all device work (`prover.device_phases`)
    — the CLI's barrier. fused=False: one after each of phase1, phase2 and
    fri. A checkpoint of either kind resumes whatever `fused` says.

    run(stop_after=phase) stops right after that barrier's save (a simulated
    crash); a later run picks up from the checkpoint, and the proof equals
    an uninterrupted `prove()`. `device` is where the remaining phases run;
    the checkpoint holds host arrays, so it may differ from the device that
    wrote it.

    `mesh` (a ``parallel.mesh.Mesh``) implies the fused barrier and runs the
    device work sharded (``protocol/fused.py``) on the mesh's device. The
    checkpoint holds the same host arrays whatever the mesh, so one written
    at one mesh size resumes at another, or solo, to the same bytes."""

    PHASES = ("phase1", "phase2", "fri", "fused", "done")

    def __init__(self, cfg: StarkConfig, secret: int, path: str, fused: bool = False, device="cuda",
                 mesh=None):
        pr.require_one_column(cfg, "the resumable prover")
        self.cfg = cfg
        self.secret = secret
        self.path = path
        self.fused = fused or mesh is not None
        self.device = device
        self.mesh = mesh

    def _save(self, phase: str, channel: Channel, arrays: dict) -> None:
        save(self.path, phase, channel, arrays, statement_fingerprint(self.cfg, self.secret))

    def _finish(self, proof: Proof) -> Proof:
        """A returned proof spends the checkpoint: remove it so a later run
        with a different statement cannot resume stale state."""
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass
        return proof

    def run(self, stop_after: str | None = None) -> Proof | None:
        if stop_after is not None and stop_after not in self.PHASES:
            raise ValueError(f"stop_after: no phase {stop_after!r} (one of {self.PHASES})")
        cfg = self.cfg
        dev = self.mesh.device if self.mesh is not None else pr.resolve_device(self.device)
        if os.path.exists(self.path):
            phase, channel, arrays = load(self.path, statement_fingerprint(cfg, self.secret))
        else:
            phase, channel, arrays = "start", Channel(), {}

        def dev_t(a):
            return fp.from_host(a, dev)

        def dev_levels(levels):
            return merkle.levels_from_host(levels, dev)

        if phase == "start" and self.fused:
            if self.mesh is None:
                out, queries = pr.device_phases(cfg, self.secret, dev, channel)
            else:
                from zkstark_tpu_torch.protocol import fused as fused_mod

                trace_mont = pr.trace_to_device(cfg, self.secret, dev)
                flat = fused_mod.fused_core_packed(cfg, trace_mont, self.mesh)
                out = fused_mod.unpack_out(cfg, fused_mod.PendingFetch(flat).wait())
                queries = pr.fused_replay(cfg, channel, out)
                out = {k: out[k] for k in PHASE_KEYS["fused"] if k in out}
            arrays = dict(out, queries_drawn=np.asarray(queries, dtype=np.int64))
            self._save("fused", channel, arrays)
            if stop_after == "fused":
                return None
            phase = "fused"

        if phase == "start":
            trace_mont = pr.trace_to_device(cfg, self.secret, dev)
            f_eval, f_res, f_levels = pr.phase1(cfg, channel, trace_mont)
            arrays = {
                "f_eval": fp.to_host(f_eval),
                "f_res": fp.to_host(f_res),
                "f_levels": _host_levels(f_levels),
            }
            self._save("phase1", channel, arrays)
            if stop_after == "phase1":
                return None
            phase = "phase1"

        if phase == "phase1":
            cp_eval, cp_res, cp_levels = pr.phase2(cfg, channel, dev_t(arrays.pop("f_eval")))
            arrays.update(
                cp_eval=fp.to_host(cp_eval),
                layer_res=[fp.to_host(cp_res)],
                layer_levels=[_host_levels(cp_levels)],
            )
            self._save("phase2", channel, arrays)
            if stop_after == "phase2":
                return None
            phase = "phase2"

        if phase == "phase2":
            layer_res, layer_levels = pr.phase3_fri(
                cfg,
                channel,
                dev_t(arrays.pop("cp_eval")),
                dev_t(arrays["layer_res"][0]),
                dev_levels(arrays["layer_levels"][0]),
            )
            arrays.update(
                layer_res=[fp.to_host(r) for r in layer_res],
                layer_levels=[_host_levels(lv) for lv in layer_levels],
            )
            self._save("fri", channel, arrays)
            if stop_after == "fri":
                return None
            phase = "fri"

        if phase == "fri":
            out, queries = pr.phase4_openings(
                cfg,
                channel,
                dev_t(arrays["f_res"]),
                dev_levels(arrays["f_levels"]),
                [dev_t(r) for r in arrays["layer_res"]],
                [dev_levels(lv) for lv in arrays["layer_levels"]],
            )
            return self._finish(pr.decommit(cfg, channel, out, queries))

        # phase == "fused" (load() refuses any phase not in PHASE_KEYS)
        queries = [int(q) for q in arrays["queries_drawn"]]
        return self._finish(pr.decommit(cfg, channel, arrays, queries))
