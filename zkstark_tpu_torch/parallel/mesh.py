"""The shard mesh and the process-group bootstrap — counterpart of
``zkstark_tpu/parallel/mesh.py``.

The JAX package annotates shardings and lets XLA insert the collectives. Here
every collective is written out, behind one small interface with two
backends:

  * a **local mesh**: S shards in one process on one device (the card, or the
    CPU in tests). Each shard's block is a separate allocation, never a view
    into a shared buffer, so a read across a shard boundary fails here as it
    would across processes; the collectives are device copies. This is the
    twin of ``--xla_force_host_platform_device_count``, and the only way one
    card runs the sharded program (NCCL puts no two ranks on one GPU);
  * a **process-group mesh** (``torch.distributed``; gloo on the CPU, NCCL on
    cards): each process holds S/P consecutive shards.

A sharded value is the list of the blocks this process holds, in shard order:
the leading (domain) axis is block-sharded over the flattened mesh, as the
JAX package's ``domain_spec`` does, so all blocks of all processes,
concatenated in shard order, are the single-device tensor. A replicated
value is one tensor, the same in every process. The collectives move int32
words (gloo refuses ``torch.uint32``); given uint32 blocks they return
uint32.

`bytes_moved` counts, per collective, the bytes that cross between two
different shards — what the same call moves between ranks when every shard
is a rank of its own; a copy from a shard to itself is not counted.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from zkstark_tpu_torch.field import fp

DOMAIN_AXIS = "shards"
HOST_AXIS = "host"
CHIP_AXIS = "chip"

_WORD = 4


def _dist_ready() -> bool:
    return dist.is_available() and dist.is_initialized()


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> int:
    """Join the process group (idempotent); returns the process count.

    Takes the group from the arguments (``coordinator_address`` "host:port",
    ``num_processes``, ``process_id``) or else from torchrun's variables
    ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``. A single
    process (no arguments and no ``WORLD_SIZE``, or a world of one) is left
    alone and gets 1. A group the caller started already is accepted as it
    is. Raises RuntimeError for a configuration that names a group but not
    all of it, or that disagrees with the group already running. The backend
    is gloo for CPU tensors and, where this torch has it, NCCL for CUDA
    tensors."""
    if num_processes is None and os.environ.get("WORLD_SIZE"):
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and os.environ.get("RANK"):
        process_id = int(os.environ["RANK"])
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        port = os.environ.get("MASTER_PORT")
        if not port:
            raise RuntimeError("initialize_distributed: MASTER_ADDR is set but MASTER_PORT is not")
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{port}"
    if _dist_ready():
        world = dist.get_world_size()
        if num_processes not in (None, world) or process_id not in (None, dist.get_rank()):
            raise RuntimeError(
                f"initialize_distributed: a group of {world} processes (this one rank "
                f"{dist.get_rank()}) is running already; asked for {num_processes} "
                f"(rank {process_id})"
            )
        return world
    if num_processes is None or num_processes == 1:
        if coordinator_address is not None and num_processes is None:
            raise RuntimeError(
                "initialize_distributed: a coordinator address without a process count "
                "(num_processes or WORLD_SIZE)"
            )
        return 1
    missing = [
        name
        for name, value in (("coordinator_address (MASTER_ADDR)", coordinator_address),
                            ("process_id (RANK)", process_id))
        if value is None
    ]
    if missing:
        raise RuntimeError(
            f"initialize_distributed: a group of {num_processes} processes needs "
            + " and ".join(missing)
        )
    if not 0 <= process_id < num_processes:
        raise RuntimeError(
            f"initialize_distributed: process {process_id} of a group of {num_processes}"
        )
    dist.init_process_group(
        backend="cpu:gloo,cuda:nccl" if dist.is_nccl_available() else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
    )
    return num_processes


def _resolve(device) -> torch.device:
    dev = fp.resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")) % torch.cuda.device_count())
    return dev


@dataclass(eq=False)
class Mesh:
    """`size` shards over `n_processes` processes; this process (`process`)
    holds the shards `local` on `device`. `shape` names the axes (flattened
    in order, process-major) and `bytes_moved` counts what crossed between
    shards, by collective. `grouped`: the collectives go through the
    process group (torch.distributed), also in a group of one process."""

    shape: dict
    device: torch.device
    n_processes: int = 1
    process: int = 0
    bytes_moved: dict = field(default_factory=dict)
    grouped: bool = False

    def __post_init__(self):
        self.size = 1
        for s in self.shape.values():
            self.size *= s
        if self.size % self.n_processes:
            raise ValueError(f"{self.size} shards do not split over {self.n_processes} processes")
        per = self.size // self.n_processes
        self.local = list(range(self.process * per, (self.process + 1) * per))

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    @property
    def is_local(self) -> bool:
        """All shards in this process and no process group: the collectives
        are device copies."""
        return not self.grouped

    def owner(self, shard: int) -> int:
        """The process that holds `shard`."""
        return shard // len(self.local)

    def reset_bytes(self) -> None:
        self.bytes_moved = {}

    def _count(self, kind: str, words: int) -> None:
        self.bytes_moved[kind] = self.bytes_moved.get(kind, 0) + words * _WORD

    # ---- placing and gathering whole vectors ----

    def shard(self, x: torch.Tensor) -> list:
        """The local blocks of the replicated vector x (leading axis split in
        S equal blocks), each a fresh allocation."""
        n = x.shape[0]
        if n % self.size:
            raise ValueError(f"mesh: {n} rows do not split over {self.size} shards")
        k = n // self.size
        return [x[s * k : (s + 1) * k].clone() for s in self.local]

    def all_gather(self, blocks: list) -> torch.Tensor:
        """The concatenation of every shard's block in shard order, on every
        process (the blocks are equal in shape)."""
        words = [fp.as_i32(b) for b in blocks]
        k = words[0].numel()
        self._count("all_gather", k * self.size * (self.size - 1))
        shape = (self.size * words[0].shape[0],) + tuple(words[0].shape[1:])
        out = torch.empty(shape, dtype=torch.int32, device=self.device)
        rows = words[0].shape[0]
        if self.is_local:
            for s, w in enumerate(words):
                out[s * rows : (s + 1) * rows].copy_(w)
        else:
            mine = torch.cat([w.reshape(-1) for w in words]) if len(words) > 1 else words[0].reshape(-1)
            parts = list(out.view(self.n_processes, -1).unbind(0))
            dist.all_gather(parts, mine.contiguous())
        return out if blocks[0].dtype == torch.int32 else fp.as_u32(out)

    # ---- the collectives of the sharded program ----

    def all_to_all(self, blocks: list) -> list:
        """Each local block holds S equal chunks, chunk t for shard t; returns
        per local shard the S chunks it was sent, in sender order (one
        flat block each)."""
        size = self.size
        words = [fp.as_i32(b).reshape(size, -1) for b in blocks]
        c = words[0].shape[1]
        self._count("all_to_all", size * (size - 1) * c)
        outs = [torch.empty(size * c, dtype=torch.int32, device=self.device) for _ in self.local]
        if self.is_local:
            for t, out in enumerate(outs):
                for s, w in enumerate(words):
                    out[s * c : (s + 1) * c].copy_(w[t])
        else:
            per = len(self.local)
            # send: by destination process q, its shards t, then our shards i
            send = torch.empty((self.n_processes, per, per, c), dtype=torch.int32,
                               device=self.device)
            for i, w in enumerate(words):
                send[:, :, i].copy_(w.view(self.n_processes, per, c))
            recv = torch.empty_like(send)  # by source process p, our shards t, its shards i
            dist.all_to_all_single(recv.view(-1), send.view(-1))
            for t, out in enumerate(outs):
                out.view(self.n_processes, per, c).copy_(recv[:, t])
        return outs if blocks[0].dtype == torch.int32 else [fp.as_u32(o) for o in outs]

    def exchange(self, blocks: list, peer_of) -> list:
        """Point-to-point moves: each local block holds K equal pieces and
        piece k of shard s goes to shard ``peer_of(s)[k]``; every shard must
        receive K pieces. Returns per local shard the K pieces it received,
        ordered by (sender, piece), as one flat block."""
        size = self.size
        words = [fp.as_i32(b) for b in blocks]
        k = len(peer_of(self.local[0]))
        c = words[0].numel() // k
        sources = {t: [] for t in range(size)}
        for s in range(size):
            dests = peer_of(s)
            if len(dests) != k:
                raise ValueError("mesh.exchange: every shard sends the same number of pieces")
            for piece, t in enumerate(dests):
                sources[t].append((s, piece))
        if any(len(v) != k for v in sources.values()):
            raise ValueError("mesh.exchange: every shard must receive as many pieces as it sends")
        self._count("exchange", c * sum(1 for t, v in sources.items() for s, _ in v if s != t))
        outs = [torch.empty(k * c, dtype=torch.int32, device=self.device) for _ in self.local]
        first = self.local[0]
        ops = []
        for s in range(size):  # one order for sends and receives on every process
            for piece, t in enumerate(peer_of(s)):
                slot = sources[t].index((s, piece))
                src_here, dst_here = s in self.local, t in self.local
                if not (src_here or dst_here):
                    continue
                piece_words = words[s - first].view(k, c)[piece] if src_here else None
                dst = outs[t - first][slot * c : (slot + 1) * c] if dst_here else None
                if src_here and dst_here:
                    dst.copy_(piece_words)
                elif src_here:
                    ops.append(dist.P2POp(dist.isend, piece_words.contiguous(), self.owner(t),
                                          tag=s * k + piece))
                else:
                    ops.append(dist.P2POp(dist.irecv, dst, self.owner(s), tag=s * k + piece))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return outs if blocks[0].dtype == torch.int32 else [fp.as_u32(o) for o in outs]

    def replicate(self, parts: list) -> torch.Tensor:
        """The bitwise OR of one equal-shape contribution per local shard over
        every shard of the mesh, on every process: where exactly one shard
        fills each word and the others give 0 (or all give the same word),
        the whole vector."""
        words = [fp.as_i32(p) for p in parts]
        acc = words[0].clone()
        for w in words[1:]:
            acc.bitwise_or_(w)
        self._count("replicate", acc.numel() * self.size * (self.size - 1))
        if not self.is_local:
            gathered = torch.empty((self.n_processes,) + tuple(acc.shape), dtype=torch.int32,
                                   device=self.device)
            dist.all_gather(list(gathered.unbind(0)), acc.contiguous())
            acc = gathered[0].clone()
            for w in gathered[1:]:
                acc.bitwise_or_(w)
        return acc if parts[0].dtype == torch.int32 else fp.as_u32(acc)


def _processes() -> tuple[int, int]:
    if _dist_ready():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_mesh(n_devices: int | None = None, device="cuda") -> Mesh:
    """A 1-D mesh of `n_devices` shards (default: one a process). In a
    single process it is a local mesh on `device`; in a process group (of
    any size, one included) the shards split evenly over the processes, each
    on its own `device` (a card a process, picked by ``LOCAL_RANK``), and the
    collectives run through the group."""
    procs, rank = _processes()
    n = procs if n_devices is None else n_devices
    if n < 1 or n % procs:
        raise ValueError(f"make_mesh: {n} shards do not split over {procs} processes")
    return Mesh({DOMAIN_AXIS: n}, _resolve(device), procs, rank, grouped=_dist_ready())


def make_host_chip_mesh(
    n_hosts: int | None = None, chips_per_host: int | None = None, device="cuda"
) -> Mesh:
    """A ('host', 'chip') 2-D mesh: hosts are the processes, chips the shards
    each process holds, flattened host-major (contiguous blocks stay in one
    process first). In a single process, hosts × chips local shards."""
    procs, rank = _processes()
    if n_hosts is None:
        n_hosts = procs
    if procs > 1 and n_hosts != procs:
        raise ValueError(f"make_host_chip_mesh: {n_hosts} hosts in a group of {procs} processes")
    chips = chips_per_host or 1
    return Mesh({HOST_AXIS: n_hosts, CHIP_AXIS: chips}, _resolve(device), procs, rank,
                grouped=_dist_ready())


def mesh_size(mesh: Mesh) -> int:
    """Total shard count of the mesh (all axes)."""
    return mesh.size
