"""The four-phase STARK prover — counterpart of ``zkstark_tpu/protocol/prover.py``.

  1. trace (host) → INTT interpolation + coset-NTT LDE + Merkle commit;
  2. pointwise constraint composition on the coset (the reference's
     polynomial divisions become products with precomputed inverse
     vanishing denominators; f(g^k·x) is a read k·blowup points ahead), one
     launch of the kernel behind ``ops/composition.py``;
  3. FRI: evaluation-form folds, each followed by a Merkle commit;
  4. decommit: per query, the trace openings and one pair per FRI layer.

`prove` has the JAX package's two paths, and both give the same bytes:

  * fused (the default): phases 1–3, the Fiat-Shamir chain and the opening
    gathers run on the device without ever waiting for the host
    (``protocol/fused.py``; the chain is the CUDA kernel of
    ``ops/fs_chain.py``). One packed vector of a few KB is fetched, the host
    `Channel` replays the transcript from the fetched roots (`fused_replay`,
    which raises `DeviceChannelMismatch` if any device-drawn challenge
    differs) and serializes the openings (`decommit`). `prove_pipelined`
    keeps several such proofs in flight.
  * host-synced (``fused=False``): the host `Channel` commits each 32-byte
    root and draws each challenge, one small fetch per commit.
    `device_phases` runs everything that touches the device (through the
    query draws and the fetch of the openings) and `decommit` the rest; the
    checkpoint (``protocol/checkpoint.py``) saves at that seam and at each
    phase.

Both paths time themselves through ``tracing.py``'s spans, which never wait
for the device; `prove(timings=)` adds waits between them.
"""

from __future__ import annotations

import functools
from collections import deque
from typing import NamedTuple

import numpy as np
import torch

from zkstark_tpu_torch import ntt, tracing
from zkstark_tpu_torch.field import fp
from zkstark_tpu_torch.field.fp import resolve_device
from zkstark_tpu_torch.hash import merkle
from zkstark_tpu_torch.ops import composition, constants, elementwise, fri_fold, powers, tables
from zkstark_tpu_torch.protocol import air, witness
from zkstark_tpu_torch.protocol.config import StarkConfig
from zkstark_tpu_torch.protocol.openings import (
    opening_shapes,
    sparse_openings,
    tree_leaves,
    unpack_tree,
)
from zkstark_tpu_torch.protocol.proof import Proof
from zkstark_tpu_torch.transcript import Channel

# On the CPU, domains up to this size get their protocol constants from exact
# host numpy, bigger ones from plain torch (prover.py:50 of the JAX package);
# on a card the kernel of ``ops/constants.py`` builds them at every size.
_HOST_CONST_MAX = 1 << 20


# Bytes of inverse denominators that stay cached (`composition_constants`):
# eight statements of 2^24 points and two constraints, or one of 2^27.
_CONST_CACHE_BYTES = 1 << 30


class _ByteBoundedCache:
    """Memoises `fn(cfg, device)` → tensor, least recently used first out,
    bounded by the tensors' bytes and not by their count: after a call, the
    oldest entries go until the rest fit `_CONST_CACHE_BYTES` (read at every
    call) or only the newest is left, which always stays, whatever its size,
    so that warm proves of one statement never rebuild it. A device table
    (``ops/tables.py``): inside a capture's recording a miss raises and a hit
    is recorded. Each function in `on_drop` is called with the (cfg, device)
    of every entry that leaves, by eviction or `cache_clear`."""

    def __init__(self, fn):
        self._fn = fn
        self._entries = {}  # insertion order is recency order
        self.on_drop = []
        functools.update_wrapper(self, fn)

    def __call__(self, cfg, device):
        key = (cfg, device)
        if key in self._entries:
            value = self._entries.pop(key)
        else:
            tables.require_warm(self.__name__)
            value = self._fn(cfg, device)
        self._entries[key] = value
        while len(self._entries) > 1 and self.cached_bytes() > _CONST_CACHE_BYTES:
            self._drop(next(iter(self._entries)))
            tracing.count("cache.evict")
        return tables.read(value)

    def cached_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self._entries.values())

    def cache_clear(self) -> None:
        for key in list(self._entries):
            self._drop(key)

    def _drop(self, key: tuple) -> None:
        del self._entries[key]
        for fn in self.on_drop:
            fn(*key)


@_ByteBoundedCache
@tracing.on_miss("composition_constants")
def composition_constants(cfg: StarkConfig, device) -> torch.Tensor:
    """One inverse denominator per constraint and point of the coset domain,
    in alpha order, as one (n_constraints, d) uint32 Montgomery tensor on
    `device`:

      Boundary(step, v):   1/(x − g^step)
      Transition(num, ex): 1/Z, Z = (x^n − 1) / Π_{e ∈ ex} (x − g^e)

    The coset offset·⟨h⟩ is disjoint from ⟨h⟩, so every denominator is
    invertible on it and the pointwise quotients equal the reference's exact
    polynomial divisions (prover.rs:101-151).

    On a card, one launch of the kernel behind ``ops/constants.py`` writes
    the whole tensor at every size. On the CPU, exact host numpy up to 2^20
    points, and above the kernel's plain-torch twin; both are also what the
    kernel is held against.

    Kept per (config, device), 4 bytes per constraint and point (1 GB at 2^27
    points and two constraints, 2 GB at 2^28), so that warm proves neither
    rebuild nor upload them. The cache is bounded by bytes
    (`_ByteBoundedCache`, `_CONST_CACHE_BYTES`), so a process that walks up
    through big statements holds one big entry at a time;
    ``composition_constants.cache_clear()`` frees them all. The domain xs
    itself is not kept: the composition kernel takes x_j from two small
    tables (`coset_domain` builds the vector for the plain version)."""
    if torch.device(device).type == "cpu" and cfg.eval_domain <= _HOST_CONST_MAX:
        return fp.from_host(np.stack(_composition_constants_host(cfg)["inv_dens"]), device)
    return constants.inverse_denominators(constants_system(cfg), cfg.field, device)


@functools.lru_cache(maxsize=None)
@tracing.on_miss("constants_system")
def constants_system(cfg: StarkConfig) -> constants.System:
    """The config's denominators encoded for ``ops/constants.py``."""
    p, g = cfg.field.p, cfg.trace_generator
    cons = [
        ("boundary", pow(g, con.step, p)) if isinstance(con, air.Boundary)
        else ("transition", tuple(pow(g, e, p) for e in con.exempt))
        for con in cfg.constraints
    ]
    return constants.encode(cons, cfg.trace_domain, cfg.blowup, cfg.domain_generator,
                            cfg.coset_offset, cfg.field)


@functools.lru_cache(maxsize=None)
def _composition_constants_host(cfg: StarkConfig) -> dict:
    """Exact numpy twin of ``ops/constants.py`` `inverse_denominators` (u64
    modular arithmetic), and the domain xs."""
    n, d, o = cfg.trace_domain, cfg.eval_domain, cfg.coset_offset
    fld = cfg.field
    g = cfg.trace_generator
    h = cfg.domain_generator
    p64 = np.uint64(fld.p)

    xs_std = fld.host_powers_pow2(h, d, scale=o)
    xs64 = xs_std.astype(np.uint64)

    inv_dens = []
    for con in cfg.constraints:
        if isinstance(con, air.Boundary):
            point = np.uint64(pow(g, con.step, fld.p))
            den = (xs64 + p64 - point) % p64
            inv_dens.append(fld.host_to_mont(fld.host_inv_vec(den)))
        else:
            xn = fld.host_pow_vec(xs64, n).astype(np.uint64)
            num = (xn + p64 - np.uint64(1)) % p64
            den = np.ones_like(xs64)
            for ex in con.exempt:
                ge = np.uint64(pow(g, ex, fld.p))
                den = (den * ((xs64 + p64 - ge) % p64)) % p64
            inv = (den * fld.host_inv_vec(num).astype(np.uint64)) % p64
            inv_dens.append(fld.host_to_mont(inv.astype(np.uint32)))
    return {"xs": fld.host_to_mont(xs_std), "inv_dens": tuple(inv_dens)}


def coset_domain(cfg: StarkConfig, device) -> torch.Tensor:
    """The coset domain xs (d,) in Montgomery form on `device`; built at each
    call (only `composition_eval_plain` reads it), in plain torch, so that
    the composition kernel's reference runs none of the port's kernels."""
    if cfg.eval_domain <= _HOST_CONST_MAX:
        return fp.from_host(_composition_constants_host(cfg)["xs"], device)
    return powers.powers_plain(cfg.field, cfg.domain_generator, cfg.eval_domain,
                               cfg.coset_offset, device)


@functools.lru_cache(maxsize=None)
@tracing.on_miss("composition_program")
def composition_program(cfg: StarkConfig) -> composition.Program:
    """The config's constraint system as the device program of
    ``ops/composition.py``."""
    p, width = cfg.field.p, cfg.air.width
    cons = [
        ("boundary", con.value % p if con.column == 0 else (con.value % p, con.column))
        if isinstance(con, air.Boundary)
        else ("transition", air.numerator_program(con.numerator, cfg.air.shifts, p, width))
        for con in cfg.constraints
    ]
    return composition.encode(cons, cfg.air.shifts, cfg.blowup, cfg.eval_domain,
                              cfg.domain_generator, cfg.coset_offset, cfg.field, width)


def _roll(x: torch.Tensor, shift: int) -> torch.Tensor:
    return fp.as_u32(torch.roll(fp.as_i32(x), shift, dims=-1))


def composition_eval_plain(cfg: StarkConfig, f_eval: torch.Tensor, alphas_mont):
    """`composition_eval` as whole-tensor field ops straight from the
    config's AIR (no device program): the numerators run on `air.device_ops`,
    f(g^k·x) is a roll by k·blowup (g = h^blowup); column j of a trace of
    w > 1 columns, f_eval (…, w, d), is f_eval[…, j, :]. What the composition
    kernel and its program are held against."""
    inv_dens = composition_constants(cfg, f_eval.device)
    xs = coset_domain(cfg, f_eval.device)
    fld = cfg.field
    b = cfg.blowup
    width = cfg.air.width
    shifted = {k: f_eval if k == 0 else _roll(f_eval, -k * b) for k in cfg.air.shifts}
    f = air.row(lambda k, j: shifted[k] if width == 1 else shifted[k][..., j, :], width)
    if isinstance(alphas_mont, torch.Tensor):
        alphas_mont = [alphas_mont[..., i : i + 1] for i in range(cfg.n_constraints)]
    acc = None
    for con, inv_den, alpha in zip(cfg.constraints, inv_dens, alphas_mont):
        if isinstance(con, air.Boundary):
            col = shifted[0] if width == 1 else shifted[0][..., con.column, :]
            num = fp.sub_f(fld, col, fld.mont_scalar(con.value))
        else:
            num = con.numerator(air.device_ops(fld), f, xs)
        term = fp.mont_mul_f(fld, fp.mont_mul_f(fld, num, inv_den), alpha)
        acc = term if acc is None else fp.add_f(fld, acc, term)
    return acc


def composition_eval_res(cfg: StarkConfig, f_eval: torch.Tensor, alphas_mont, res_out=None):
    """Pointwise constraint composition on the coset (prover.rs:87-180)
    from the config's AIR, through `ops.composition.composition`: one kernel
    launch on a CUDA tensor. f_eval: (…, d) uint32 Montgomery, the leading
    axes independent proofs ((…, w, d) for a trace of w > 1 columns);
    alphas_mont: Montgomery-form ints, one per constraint, or a (…,
    n_constraints) uint32 device tensor. Returns
    (cp_eval, cp_res): Montgomery form and standard residues, the residues
    written into `res_out` where given."""
    return composition.composition(
        f_eval, composition_constants(cfg, f_eval.device), alphas_mont,
        composition_program(cfg), cfg.field, res_out=res_out,
    )


def composition_eval(cfg: StarkConfig, f_eval: torch.Tensor, alphas_mont):
    """`composition_eval_res` without the residues (the JAX package's
    signature)."""
    return composition_eval_res(cfg, f_eval, alphas_mont)[0]


def _fri_layer_params(cfg: StarkConfig, layer: int):
    """(1/h^{2^k}, 1/offset^{2^k}) of FRI layer k, whose domain is
    {offset^{2^k}·(h^{2^k})^j}: 1/x_j = inv_off·inv_base^j."""
    p = cfg.field.p
    base = pow(cfg.domain_generator, 1 << layer, p)
    off = pow(cfg.coset_offset, 1 << layer, p)
    return pow(base, p - 2, p), pow(off, p - 2, p)


def fri_layer_constants(cfg: StarkConfig, layer: int) -> np.ndarray:
    """1/x_j for j < m/2 of FRI layer `layer` (m its domain size), Montgomery
    uint32 host numpy: the inverse first half-domain that the fold's
    `_fri_layer_params` tables stand for, as the JAX package returns it."""
    inv_base, inv_off = _fri_layer_params(cfg, layer)
    fld = cfg.field
    return fld.host_to_mont(fld.host_powers_pow2(inv_base, (cfg.eval_domain >> layer) // 2,
                                                 scale=inv_off))


def fri_fold_eval(cfg: StarkConfig, layer: int, evals: torch.Tensor, beta_mont, build=None,
                  res_out=None):
    """Evaluation-form FRI fold P'(x²) = (P(x)+P(−x))/2 + β·(P(x)−P(−x))/(2x)
    — the reference's coefficient fold (polynomial.rs:385-400) on the
    halved-and-squared domain — through `ops.fri_fold.fri_fold`. evals
    (…, m): the last axis is the layer domain, the leading axes independent
    proofs; beta_mont a Montgomery-form int, or a uint32 device tensor with
    one challenge per proof. `build` replaces `merkle.build_levels` (the
    batched prover passes `merkle.build_levels_batch`); the residues are
    written into `res_out` where given. Returns (folded, residues, Merkle
    levels)."""
    inv_base, inv_off = _fri_layer_params(cfg, layer)
    folded, res = fri_fold.fri_fold(evals, beta_mont, inv_base, inv_off, cfg.field,
                                    res_out=res_out)
    return folded, res, (build or merkle.build_levels)(res)


class ProverArtifacts:
    """Per-phase outputs kept for decommitment and inspection (device
    tensors)."""

    def __init__(self):
        self.f_res = None
        self.f_tree = None
        self.layer_res = []  # residues per FRI layer, layer 0 = cp_eval
        self.layer_trees = []
        self.query_indices = []

    @property
    def query_index(self):
        return self.query_indices[0] if self.query_indices else None


def _lap(timings: dict | None, key: str, dev: torch.device, *spans: str) -> None:
    """Add to `timings[key]` the seconds of the latest spans `spans` and of a
    wait for the device (the span `sync`); nothing when timings is None."""
    if timings is None:
        return
    with tracing.span("sync"):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    timings[key] = timings.get(key, 0.0) + sum(map(tracing.last_ns, (*spans, "sync"))) * 1e-9


def _root_bytes(levels: list) -> bytes:
    return merkle.MerkleTree(levels=levels).root()


class DeviceChannelMismatch(RuntimeError):
    """The device-derived Fiat-Shamir chain disagreed with the host replay."""


def upload(arr, device: torch.device) -> torch.Tensor:
    """uint32 host words → device tensor without waiting for the device: on
    a card the words are sent from pinned memory, asynchronously on the
    current stream (a copy from pageable memory would first wait for every
    kernel already enqueued, which is what pipelined proving must not do).
    `arr`: a numpy array, staged in pinned memory first, or the int32 host
    tensor of `witness_words`, already pinned on a card and sent as it is."""
    with tracing.span("upload"):
        if isinstance(arr, np.ndarray):
            arr = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.uint32).view(np.int32))
        if device.type != "cuda":
            return fp.as_u32(arr.to(device))
        return fp.as_u32(arr.pin_memory().to(device, non_blocking=True))


def witness_words(cfg: StarkConfig, secrets, device: torch.device):
    """(words, last) of the witnesses of `secrets` (``protocol/witness.py``):
    words, their (B, trace_len) Montgomery words ((B, w, trace_len) for a
    trace of w > 1 columns) in an int32 host tensor that `upload` sends to
    `device` (pinned on a card); last, each trace's output (canonical)."""
    width = cfg.air.width
    shape = (len(secrets), cfg.trace_len) if width == 1 else (len(secrets), width, cfg.trace_len)
    words = torch.empty(shape, dtype=torch.int32, pin_memory=device.type == "cuda")
    _, last = witness.traces(cfg.air, secrets, cfg.trace_len, cfg.field,
                             out=words.numpy().view(np.uint32))
    return words, last


def require_one_column(cfg: StarkConfig, what: str) -> None:
    """Raise ValueError, naming the width, where `cfg`'s trace has more than
    one column: for the entries that prove traces of one column only."""
    if cfg.air.width != 1:
        raise ValueError(f"{what} proves traces of one column; the {cfg.air.name!r} AIR has "
                         f"width {cfg.air.width}")


def trace_to_device(cfg: StarkConfig, secret: int, device) -> torch.Tensor:
    """The witness (host) in Montgomery form on `device`; raises ValueError
    if it does not meet the public boundary."""
    dev = torch.device(device)
    with tracing.span("witness"):
        words, last = witness_words(cfg, [secret], dev)
        if int(last[0]) != cfg.boundary_last:
            raise ValueError(
                "witness does not satisfy the public boundary: trace endpoint "
                f"{int(last[0])} != {cfg.boundary_last}"
            )
    return upload(words[0], dev)


def phase1(cfg: StarkConfig, channel: Channel, trace_mont: torch.Tensor):
    """Interpolate → LDE → commit (prover.rs:24-85): (f_eval, f_res, f_levels)."""
    fld = cfg.field
    coeffs = air.interpolate_trace(trace_mont, cfg.trace_domain, fld)
    f_eval = ntt.coset_ntt(coeffs, cfg.eval_domain, cfg.coset_offset, fld)
    f_res = elementwise.from_mont(f_eval, fld)
    f_levels = merkle.build_levels(f_res)
    channel.commit_hash(_root_bytes(f_levels))
    return f_eval, f_res, f_levels


def phase2(cfg: StarkConfig, channel: Channel, f_eval: torch.Tensor):
    """Composition (prover.rs:87-180): (cp_eval, cp_res, cp_levels)."""
    fld = cfg.field
    alphas = [fld.mont_scalar(channel.get_u32()) for _ in range(cfg.n_constraints)]
    cp_eval, cp_res = composition_eval_res(cfg, f_eval, alphas)
    cp_levels = merkle.build_levels(cp_res)
    channel.commit_hash(_root_bytes(cp_levels))
    return cp_eval, cp_res, cp_levels


def phase3_fri(cfg: StarkConfig, channel: Channel, cp_eval, cp_res, cp_levels):
    """FRI (prover.rs:182-254): every fold and commit, then the free term.
    Returns (layer_res, layer_levels); layer 0 is the composition."""
    fld = cfg.field
    layer_res, layer_levels = [cp_res], [cp_levels]
    evals = cp_eval
    for layer in range(cfg.fri_rounds):
        beta = fld.mont_scalar(channel.get_u32())
        evals, res, levels = fri_fold_eval(cfg, layer, evals, beta)
        layer_res.append(res)
        layer_levels.append(levels)
        channel.commit_hash(_root_bytes(levels))
    channel.commit_u32(int(fp.to_host(layer_res[-1][:1])[0]))
    return layer_res, layer_levels


def phase4_openings(cfg: StarkConfig, channel: Channel, f_res, f_levels, layer_res, layer_levels):
    """The query draws and every opening they need, gathered on the device
    and fetched in one transfer: (host openings dict, queries)."""
    queries = [channel.get_u32() % cfg.query_range for _ in range(cfg.n_queries)]
    return sparse_openings(cfg, f_res, f_levels, layer_res, layer_levels, queries), queries


def device_phases(
    cfg: StarkConfig,
    secret: int,
    device,
    channel: Channel,
    artifacts: ProverArtifacts | None = None,
    timings: dict | None = None,
):
    """Everything of a proof that touches the device: the witness upload,
    phases 1–3, the query draws and the openings. Returns the host openings
    and the queries; what is left is `decommit`, host only. This is the
    checkpoint's last barrier (protocol/checkpoint.py, phase "fused").
    `timings`: as `prove(fused=False)` fills it, less `phase4_decommit`."""
    dev = resolve_device(device)
    trace_mont = trace_to_device(cfg, secret, dev)
    _lap(timings, "trace", dev, "witness", "upload")
    with tracing.span("phase1_lde_commit"):
        f_eval, f_res, f_levels = phase1(cfg, channel, trace_mont)
    _lap(timings, "phase1_lde_commit", dev, "phase1_lde_commit")
    with tracing.span("phase2_composition"):
        cp_eval, cp_res, cp_levels = phase2(cfg, channel, f_eval)
    _lap(timings, "phase2_composition", dev, "phase2_composition")
    with tracing.span("phase3_fri"):
        layer_res, layer_levels = phase3_fri(cfg, channel, cp_eval, cp_res, cp_levels)
    _lap(timings, "phase3_fri", dev, "phase3_fri")
    with tracing.span("phase4_openings"):
        out, queries = phase4_openings(cfg, channel, f_res, f_levels, layer_res, layer_levels)
    if artifacts is not None:
        artifacts.f_res, artifacts.f_tree = f_res, merkle.MerkleTree(levels=f_levels)
        artifacts.layer_res = layer_res
        artifacts.layer_trees = [merkle.MerkleTree(levels=lv) for lv in layer_levels]
        artifacts.query_indices = list(queries)
    return out, queries


class DecommitLayout(NamedTuple):
    """Where a proof's decommit transcript comes from (`decommit_layout`).
    Every field of it is a whole 32-bit word (a u32 value, a u64 path length
    as two words, a digest as eight), so the map is laid per word.

    index: the byte map, one np.intp entry per 4 bytes: `np.take(src,
      index)`, viewed as bytes, is the whole transcript, where src is the
      `words` words of the opening leaves big-endian (`pack_tree`'s order:
      the path words as `digest_to_bytes` lays them), then the words of the
      value leaves and `tail` little-endian (`bincode.ser_u32`'s order);
    cuts: the byte offset at which each of the reference's commits ends, in
      commit order (the last one the transcript's length);
    tail: the bincode u64 path lengths, one per distinct depth, as
      little-endian uint32 pairs (length, 0);
    words: the words of the opening leaves;
    src_words: the words of src."""

    index: np.ndarray
    cuts: tuple
    tail: np.ndarray
    words: int
    src_words: int


# the opening leaves' keys, the same for every statement, and those of values
_OPENING_KEYS = tuple(opening_shapes(StarkConfig()))
_VALUE_KEYS = ("open_cp_vals", "open_f_vals", "open_fri_vals")


@functools.lru_cache(maxsize=16)
@tracing.on_miss("decommit_layout")
def decommit_layout(cfg: StarkConfig) -> DecommitLayout:
    """The byte map and the commit cuts of `decommit` for the statement's
    shapes (queries, shifts, FRI rounds, depth). The commits are the
    reference's (prover.rs:256-289), generalised to n_queries: per query,
    each trace shift's (u32, AuthPath) (the row's w u32s, then the path, for
    a trace of w > 1 columns), the composition's, then per FRI layer (u32,
    u32, AuthPath, AuthPath)."""
    shapes = opening_shapes(cfg)
    value_shapes = {key: shapes[key] for key in _VALUE_KEYS}
    words = sum(int(np.prod(shape)) for shape in tree_leaves(shapes))
    value_words = sum(int(np.prod(shape)) for shape in tree_leaves(value_shapes))
    # each leaf word's position in src: big-endian, and the values' little-endian
    big = unpack_tree(np.arange(words), shapes)
    little = unpack_tree(words + np.arange(value_words), value_shapes)
    depth = cfg.eval_domain.bit_length() - 1
    depths = range(depth - cfg.fri_rounds + 1, depth + 1)
    tail = np.array([(d, 0) for d in depths], dtype="<u4").reshape(-1)
    length_at = {d: words + value_words + 2 * j + np.arange(2) for j, d in enumerate(depths)}
    pieces, cuts = [], [0]

    def commit(values, *paths):
        got = [values.reshape(-1)]
        for path in paths:
            got += [length_at[path.shape[0]], path.reshape(-1)]
        pieces.extend(got)
        cuts.append(cuts[-1] + 4 * sum(piece.size for piece in got))

    for qi in range(cfg.n_queries):
        for si in range(len(cfg.air.shifts)):
            commit(little["open_f_vals"][qi, si], big["open_f_paths"][qi, si])
        commit(little["open_cp_vals"][qi], big["open_cp_paths"][qi])
        for vals, paths in zip(little["open_fri_vals"], big["open_fri_paths"]):
            commit(vals[qi], paths[qi, 0], paths[qi, 1])
    index = np.concatenate(pieces)
    for shared in (index, tail):  # every caller of the cache reads the same arrays
        shared.setflags(write=False)
    return DecommitLayout(index, tuple(cuts[1:]), tail, words, words + value_words + tail.size)


def _words(out: dict, keys) -> list:
    return [np.asarray(leaf, dtype=np.uint32).reshape(-1) for leaf in tree_leaves(out, keys)]


def decommit(cfg: StarkConfig, channel: Channel, out: dict, queries: list) -> Proof:
    """Phase 4 from the fetched openings, then the final state: the
    transcript's bytes laid down by one gather through `decommit_layout`'s
    byte map and committed by its cuts (`Channel.commit_cuts`), in the
    reference's commit order (prover.rs:256-289), generalised to n_queries.
    Counts the openings serialized (``decommit.openings``, a FRI pair one, a
    trace row one for each shift) and the bytes committed
    (``decommit.bytes``), once a call."""
    with tracing.span("decommit"):
        layout = decommit_layout(cfg)
        leaves = _words(out, _OPENING_KEYS)
        size = sum(leaf.size for leaf in leaves)
        if size != layout.words or len(queries) != cfg.n_queries:
            raise ValueError(f"openings of {size} words and {len(queries)} queries do not fit "
                             "the statement")
        src = np.empty(layout.src_words, dtype="<u4")
        np.concatenate(leaves, out=src[:size].view(">u4"))
        np.concatenate([*_words(out, _VALUE_KEYS), layout.tail], out=src[size:])
        payload = np.take(src, layout.index).view(np.uint8)
        channel.commit_cuts(payload, layout.cuts)
        tracing.count("decommit.openings", len(layout.cuts))
        tracing.count("decommit.bytes", payload.size)
        state, data = channel.finalize()
        return Proof(state=state, data=data)


def fused_replay(cfg: StarkConfig, channel: Channel, out: dict) -> list:
    """Replay the byte transcript through the host channel from the fused
    core's fetched roots, raising `DeviceChannelMismatch` unless every
    host-derived challenge equals the device-derived one: each proof holds
    the device chain against the host chain. `out` is one proof's fetched
    `fused_core` dict (numpy). Returns the query indices."""
    with tracing.span("replay"):
        roots = np.asarray(out["roots"], dtype=">u4").tobytes()  # 32 bytes a root
        channel.commit_hash(roots[:32])
        for k in range(cfg.n_constraints):
            if channel.get_u32() != int(out["alphas"][k]):
                raise DeviceChannelMismatch(f"alpha[{k}]")
        channel.commit_hash(roots[32:64])
        for layer in range(cfg.fri_rounds):
            if channel.get_u32() != int(out["betas"][layer]):
                raise DeviceChannelMismatch(f"beta[{layer}]")
            channel.commit_hash(roots[32 * (2 + layer) : 32 * (3 + layer)])
        channel.commit_u32(int(out["free_term"]))
        queries = []
        for qi in range(cfg.n_queries):
            x = channel.get_u32() % cfg.query_range
            if x != int(out["queries"][qi]):
                raise DeviceChannelMismatch(f"query index {qi}")
            queries.append(x)
        return queries


def finish_fused(cfg: StarkConfig, out: dict, artifacts: ProverArtifacts | None = None,
                 channel: Channel | None = None) -> Proof:
    """One proof's fetched `fused_core` dict → Proof: host replay through
    `channel` (a new one by default), then the serialization of the
    openings."""
    channel = Channel() if channel is None else channel
    queries = fused_replay(cfg, channel, out)
    if artifacts is not None:
        artifacts.query_indices = list(queries)
    return decommit(cfg, channel, out, queries)


def prove(
    cfg: StarkConfig = StarkConfig(),
    secret: int = 3141592,
    device="cuda",
    artifacts: ProverArtifacts | None = None,
    timings: dict | None = None,
    fused: bool = True,
    mesh=None,
    channel: Channel | None = None,
) -> Proof:
    """A proof byte-identical to the reference's generate_proof
    (prover.rs:9-293) and to ``zkstark_tpu.protocol.prove`` for the same
    config and witness. `device` is where every vector and Merkle level lives
    ("cuda" runs the CUDA kernels and raises if there is no CUDA device).

    fused=True (the default, as in the JAX package): the device runs phases
    1–3 and derives every challenge itself, one packed result is fetched, and
    the host replays the transcript and checks every challenge against the
    device's. `artifacts` then receives the query indices only. `timings`, if
    given, is filled with the spans `trace`, `device_program`, `fetch` and
    `replay_decommit`, in seconds, each followed by a wait for the device:
    from ``tracing.py``'s spans, `trace` = witness + upload, `device_program`
    = enqueue, `fetch` the fetch and unpacking, `replay_decommit` = replay +
    decommit, each with its wait. Only with `timings` does the prover wait
    between its steps.
    fused=False: the host-synced path (`device_phases`, then `decommit`), one
    fetch per commit, with the spans `trace`, `phase1_lde_commit`,
    `phase2_composition`, `phase3_fri` and `phase4_decommit`, each ending
    with a wait for the device likewise.

    mesh: a ``parallel.mesh.Mesh`` — the fused program sharded over the
    evaluation domain on the mesh's device (`device` is then not read); the
    bytes are the same at any mesh size and shape, and on a process-group
    mesh every process returns the same proof. Needs the fused path and a
    trace of one column (ValueError otherwise, before any launch).

    channel: the transcript to prove into (default: a new one), as in the
    JAX package. The host-synced path commits to it as it goes; the fused
    path replays the device's chain through it, and the device chain starts
    from the zero state, so a channel that is not new raises
    `DeviceChannelMismatch` there, as the JAX package's does."""
    if mesh is not None and not fused:
        raise ValueError("sharded proving requires the fused path")
    if mesh is not None:
        require_one_column(cfg, "sharded proving")
    with tracing.span("prove"):
        dev = mesh.device if mesh is not None else resolve_device(device)
        if fused:
            from zkstark_tpu_torch.protocol import fused as fused_mod

            trace_mont = trace_to_device(cfg, secret, dev)
            _lap(timings, "trace", dev, "witness", "upload")
            flat = fused_mod.fused_core_packed(cfg, trace_mont, mesh)
            _lap(timings, "device_program", dev, "enqueue")
            with tracing.span("fetch"):
                out = fused_mod.unpack_out(cfg, fused_mod.PendingFetch(flat).wait())
            _lap(timings, "fetch", dev, "fetch")
            proof = finish_fused(cfg, out, artifacts, channel)
            _lap(timings, "replay_decommit", dev, "replay", "decommit")
            return proof
        channel = Channel() if channel is None else channel
        out, queries = device_phases(cfg, secret, dev, channel, artifacts, timings)
        proof = decommit(cfg, channel, out, queries)
        _lap(timings, "phase4_decommit", dev, "phase4_openings", "decommit")
        return proof


def prove_pipelined(cfg: StarkConfig, secrets, depth: int = 2, device="cuda") -> list:
    """Prove a sequence of witnesses with the device kept busy: up to `depth`
    fused device programs stay enqueued while the host computes the next
    witness and fetches, replays and serializes earlier proofs. The fused
    core never waits for the device, and each packed result is copied to
    pinned host memory behind an event, so the host blocks only on the oldest
    proof in flight. Every proof's bytes equal a solo `prove` of the same
    secret: the chains run on the device and no proof depends on another.
    All proofs share the current stream, so they run on the card one after
    the other and the tensors of one are freed for the next."""
    from zkstark_tpu_torch.protocol import fused as fused_mod

    with tracing.span("prove_pipelined"):
        dev = resolve_device(device)
        pending, proofs = deque(), []

        def finish():
            proofs.append(finish_fused(cfg, fused_mod.unpack_out(cfg, pending.popleft().wait())))

        for s in secrets:
            trace_mont = trace_to_device(cfg, s, dev)
            pending.append(fused_mod.PendingFetch(fused_mod.fused_core_packed(cfg, trace_mont)))
            if len(pending) > depth:
                finish()
        while pending:
            finish()
        return proofs
