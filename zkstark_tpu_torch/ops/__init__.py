"""Hand-written CUDA kernels for Hopper and their wrappers.

Each wrapper launches its kernel for a CUDA tensor (or raises) and takes its
plain-torch twin only for a tensor on the CPU. `launch_counts` reads the
per-kernel launch counters, `add_launch_counts` adds to them (a replayed CUDA
graph's launches) and `reset_launch_counts` zeroes them."""

from zkstark_tpu_torch.ops import (
    composition,
    constants,
    elementwise,
    fri_fold,
    fs_chain,
    limb_dft,
    ntt_kernel,
    openings,
    powers,
    sha256_kernel,
)


# kernel → (its wrapper module, the module's launch counter)
_COUNTERS = {
    "sha256_leaf": (sha256_kernel, "leaf_launches"),
    "sha256_leaf_rows": (sha256_kernel, "leaf_rows_launches"),
    "sha256_node": (sha256_kernel, "node_launches"),
    "sha256_tree_tail": (sha256_kernel, "tail_launches"),
    "sha256_leaf_planes": (sha256_kernel, "leaf_planes_launches"),
    "sha256_node_planes": (sha256_kernel, "node_planes_launches"),
    "ntt_rows": (ntt_kernel, "ntt_launches"),
    "transpose": (ntt_kernel, "transpose_launches"),
    "ntt_rows_pease": (ntt_kernel, "pease_launches"),
    "fs_chain": (fs_chain, "chain_launches"),
    "fri_fold": (fri_fold, "fold_launches"),
    "limb_dft_rows": (limb_dft, "limb_launches"),
    "composition": (composition, "composition_launches"),
    "openings": (openings, "openings_launches"),
    "endpoint_fix": (elementwise, "endpoint_launches"),
    "from_mont": (elementwise, "from_mont_launches"),
    "constants": (constants, "constants_launches"),
    "powers": (powers, "powers_launches"),
}


def launch_counts() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in _COUNTERS.items()}


def add_launch_counts(counts: dict) -> None:
    """Add `counts` ({kernel: launches}) to the counters: the launches of a
    replayed CUDA graph, which no wrapper counts."""
    for name, n in counts.items():
        mod, attr = _COUNTERS[name]
        setattr(mod, attr, getattr(mod, attr) + n)


def reset_launch_counts() -> None:
    for mod, attr in _COUNTERS.values():
        setattr(mod, attr, 0)
