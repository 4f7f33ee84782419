"""Phase-4 openings as sparse device gathers — counterpart of
``zkstark_tpu/protocol/fused.py`` ``_take_val`` / ``_take_digest`` /
``_auth_path`` / ``sparse_openings``.

The opened values and the auth-path sibling digests are gathered on the
device and fetched in one transfer of a few KB; the Merkle levels (about
3 GB at a 2^24 domain) never leave the device.

`sparse_openings_device` takes the query indices as a device tensor of any
leading batch shape and returns device tensors, so the fused core
(``protocol/fused.py``) never waits for the host; `pack_tree` / `unpack_tree`
carry such a dict to the host as one vector. `sparse_openings` is the same
for host query indices, fetched at once (the host-synced prover).
"""

from __future__ import annotations

import numpy as np
import torch

from zkstark_tpu_torch.field import fp


def map_leaves(tree: dict, fn) -> dict:
    """fn on every leaf of a dict whose values are leaves or lists of leaves."""
    return {k: [fn(t) for t in v] if isinstance(v, list) else fn(v) for k, v in tree.items()}


def pack_tree(out: dict) -> torch.Tensor:
    """Every uint32 leaf of a dict of device tensors ravelled into one flat
    device vector (keys sorted, lists in order): one transfer instead of some
    thirty, re-sliced on the host by `unpack_tree`."""
    leaves = []
    for key in sorted(out):
        leaves += out[key] if isinstance(out[key], list) else [out[key]]
    return fp.as_u32(torch.cat([fp.as_i32(leaf).reshape(-1) for leaf in leaves]))


def unpack_tree(flat: np.ndarray, shapes: dict) -> dict:
    """Host-side inverse of `pack_tree`: `shapes` is the dict of the leaves'
    shapes; returns numpy arrays in that structure."""
    flat = np.asarray(flat)
    pos = 0

    def take(shape):
        nonlocal pos
        size = int(np.prod(shape, dtype=np.int64))
        part = flat[pos : pos + size].reshape(shape)
        pos += size
        return part

    out = {}
    for key in sorted(shapes):
        v = shapes[key]
        out[key] = [take(s) for s in v] if isinstance(v, list) else take(v)
    assert pos == flat.shape[0], (pos, flat.shape)
    return out


def sparse_openings(cfg, f_res, f_levels, layer_res, layer_levels, queries) -> dict:
    """Every phase-4 opening (values and auth-path siblings) for the host
    query indices `queries`, as host numpy, in one transfer:
    `sparse_openings_device` on the uploaded indices, then one fetch. Layer 0
    of layer_res / layer_levels is the composition tree."""
    idx = fp.from_host(np.asarray(queries, dtype=np.uint32), f_res.device)
    out = sparse_openings_device(cfg, f_res, f_levels, layer_res, layer_levels, idx)
    return unpack_tree(fp.to_host(pack_tree(out)), map_leaves(out, lambda t: tuple(t.shape)))


def _take_vals(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr (…, n) uint32, idx (…, r) int64 on the device → (…, r) int32 bits."""
    return torch.take_along_dim(fp.as_i32(arr), idx, dim=-1)


def _auth_paths(levels: list, idx: torch.Tensor) -> torch.Tensor:
    """Sibling digests leaf→root of the device indices idx (…, r) in the
    trees `levels` ((…, k, 8) each): (…, r, depth, 8) int32 bits. One gather
    per level; the sibling index of every level comes from one shift."""
    depth = len(levels) - 1
    if depth == 0:
        return torch.zeros(idx.shape + (0, 8), dtype=torch.int32, device=idx.device)
    shifts = torch.arange(depth, dtype=torch.int64, device=idx.device)
    sib = (idx[..., None] >> shifts) ^ 1  # (…, r, depth)
    rows = [
        torch.take_along_dim(
            fp.as_i32(level), sib[..., d, None].expand(sib.shape[:-1] + (8,)), dim=-2
        )
        for d, level in enumerate(levels[:-1])
    ]
    return torch.stack(rows, dim=-2)


def sparse_openings_device(cfg, f_res, f_levels, layer_res, layer_levels, queries) -> dict:
    """`sparse_openings` with the query indices on the device: `queries` is a
    (…, q) uint32 tensor whose leading axes match those of the values (…, n)
    and levels (…, k, 8). Returns uint32 device tensors with the JAX
    package's shapes behind the leading axes: open_f_vals (…, q, n_shifts),
    open_f_paths (…, q, n_shifts, depth, 8), open_cp_vals (…, q),
    open_cp_paths (…, q, depth, 8) and per FRI layer open_fri_vals (…, q, 2),
    open_fri_paths (…, q, 2, depth, 8). Makes no call that waits for the
    device."""
    x = fp.wide(queries)  # (…, q) int64
    lead, q = x.shape[:-1], x.shape[-1]
    shifts = cfg.air.shifts
    f_idx = torch.stack([x + k * cfg.blowup for k in shifts], dim=-1)
    f_idx = f_idx.reshape(lead + (q * len(shifts),))
    f_depth = len(f_levels) - 1
    out = {
        "open_f_vals": _take_vals(f_res, f_idx).reshape(lead + (q, len(shifts))),
        "open_f_paths": _auth_paths(f_levels, f_idx).reshape(lead + (q, len(shifts), f_depth, 8)),
        "open_cp_vals": _take_vals(layer_res[0], x),
        "open_cp_paths": _auth_paths(layer_levels[0], x),
        "open_fri_vals": [],
        "open_fri_paths": [],
    }
    for layer in range(cfg.fri_rounds):
        size = cfg.eval_domain >> layer
        xi = x & (size - 1)
        idx = torch.stack([xi, (xi + size // 2) & (size - 1)], dim=-1).reshape(lead + (2 * q,))
        out["open_fri_vals"].append(_take_vals(layer_res[layer], idx).reshape(lead + (q, 2)))
        out["open_fri_paths"].append(
            _auth_paths(layer_levels[layer], idx).reshape(
                lead + (q, 2, len(layer_levels[layer]) - 1, 8)
            )
        )
    return {
        k: [fp.as_u32(t) for t in v] if isinstance(v, list) else fp.as_u32(v)
        for k, v in out.items()
    }
