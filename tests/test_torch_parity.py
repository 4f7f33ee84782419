"""The port covers the JAX package: every public name of every module of
``zkstark_tpu/``, every public member of its classes and every parameter
name of its public functions and methods has its counterpart in
``zkstark_tpu_torch/``.

The JAX names are read with `ast`, so no TPU code is imported to list them:
the top-level functions, classes, UPPER_CASE constants and an
``__init__.py``'s ``__all__`` (not imported names), written ``path:name``;
the members of each public class, read from its body (methods, properties,
UPPER_CASE class attributes and annotated fields), ``path:Class.member``;
and the parameter names of each public function and method (``__init__``
included, ``self`` and ``cls`` not), ``path:function(param)`` and
``path:Class.method(param)``. Each is one case, and each case holds exactly
one of:

  (a) the port's module of the same relative path has the name, the class
      there has the member (an attribute, a dataclass or NamedTuple field, a
      slot), or the function there takes a parameter of that name (the port
      may take more, such as ``device=``; positional order is not compared:
      the port's ``prove(cfg, secret, device, …)`` differs and its callers
      depend on it);
  (b) `RENAMED` points it at a port name that exists and computes the same
      thing, held equal to the JAX function by the test its entry names;
  (c) `NOT_PORTED` gives the reason in one line. It holds only what has no
      meaning on the card: the XLA runtime helpers, the Pallas grid emulator
      and switches, the GSPMD sharding specs (the port shards by the block
      lists of ``parallel/__init__.py``), the planar storage policy of the
      Merkle trees, which the A/B of PERF.md found slower on the card, the
      stage tables the port's plans do not hold, and two arguments the card
      does not need.

The members and parameters of a name that is itself `RENAMED` or
`NOT_PORTED` are covered by that entry and are not walked.

Below the walk, the equality tests of the names this file's maps need and no
other test holds, and of the names added beside them: `alt_field_config`,
the native channel primitives, `fri_layer_constants`, `FourStepPlan`.
"""

import ast
import dataclasses
import hashlib
import importlib
import inspect
import shutil
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "zkstark_tpu"

# JAX name → (port name, the test that holds the two equal)
RENAMED = {
    "ops/mxu_ntt.py:dft_matmul": (
        "ops/limb_dft.py:limb_dft_rows", "test_torch_parity.py::test_dft_matmul_is_limb_dft_rows"),
    "ops/mxu_ntt.py:col_transform_mxu": (
        "ops/limb_dft.py:limb_dft_rows",
        "test_torch_limb_dft.py::test_limb_rows_match_jax_and_radix2"),
    "ops/mxu_ntt.py:mxu_enabled": (
        "ops/limb_dft.py:mxu_enabled",
        "test_torch_limb_dft.py::test_mxu_switch_is_read_at_every_call"),
    "ops/mxu_ntt.py:mxu_supported": (
        "ops/limb_dft.py:mxu_supported", "test_torch_limb_dft.py::test_supported_sizes_match_jax"),
    "ops/ntt_kernel.py:MAX_COLS_SIZE": (
        "ops/ntt_kernel.py:MAX_ROW", "test_torch_parity.py::test_max_row_is_max_cols_size"),
    "protocol/fused.py:sparse_openings": (
        "protocol/openings.py:sparse_openings",
        "test_torch_openings_kernel.py::test_openings_match_jax"),
    "protocol/prover.py:fused_decommit": (
        "protocol/prover.py:decommit",
        "test_torch_parity.py::test_decommit_writes_fused_decommit_bytes"),
    # members and parameters
    "ops/ntt_kernel.py:FourStepPlan.u": (
        "ops/ntt_kernel.py:FourStepPlan.ut", "test_torch_parity.py::test_fourstep_plan"),
    "ops/ntt_kernel.py:FourStepPlan.v": (
        "ops/ntt_kernel.py:FourStepPlan.vt", "test_torch_parity.py::test_fourstep_plan"),
    "ops/sha256_kernel.py:node_hash_pairs(pairs)": (
        "ops/sha256_kernel.py:node_hash_pairs(children)",
        "test_torch_sha256_merkle.py::test_node_hash_matches_jax"),
    "hash/merkle.py:planar_to_natural(level)": (
        "hash/merkle.py:planar_to_natural(planes)",
        "test_torch_sha256_planes.py::test_planar_to_natural"),
    "hash/merkle.py:build_levels(planar)": (
        "hash/merkle.py:build_levels(planar_stop)", "test_torch_sha256_planes.py::test_chain_levels"),
    "parallel/mesh.py:make_mesh(backend)": (
        "parallel/mesh.py:make_mesh(device)", "test_torch_parity.py::test_mesh_device_is_backend"),
    "parallel/mesh.py:make_host_chip_mesh(backend)": (
        "parallel/mesh.py:make_host_chip_mesh(device)",
        "test_torch_parity.py::test_mesh_device_is_backend"),
    "parallel/fri_sharded.py:fold_sharded(beta_mont)": (
        "parallel/fri_sharded.py:fold_sharded(beta)", "test_torch_sharded.py::test_fold_matches_jax"),
    "parallel/fri_sharded.py:fold_sharded(inv_x)": (
        "parallel/fri_sharded.py:fold_sharded(inv_base)",
        "test_torch_sharded.py::test_fold_matches_jax"),
    "parallel/merkle_sharded.py:sharded_build_levels(values)": (
        "parallel/merkle_sharded.py:sharded_build_levels(blocks)",
        "test_torch_sharded.py::test_sharded_levels_match_jax"),
    "parallel/merkle_sharded.py:sharded_commit(values)": (
        "parallel/merkle_sharded.py:sharded_commit(blocks)",
        "test_torch_sharded.py::test_sharded_levels_match_jax"),
}

_RUNTIME = "the XLA runtime: the port has no compilation cache or transfer path to warm"
_GRID = "the Pallas grid emulator: the CUDA kernels have no interpret mode to emulate"
_PALLAS = "the Pallas switch: every four-step and hash runs its CUDA kernel on a card"
_GSPMD = "a GSPMD sharding spec: the port's shards are the block lists of parallel/__init__.py"
_PLANAR = ("the planar storage policy: on the card the plane-major tree was slower than "
           "row-major in both turns of the A/B (PERF.md)")
_STAGES = ("a stage table: the port's plans hold none, the row kernels take their stage roots "
           "from the root itself")
NOT_PORTED = {
    "runtime.py:enable_compilation_cache": _RUNTIME,
    "runtime.py:warm_transfer_path": _RUNTIME,
    "runtime.py:profiler_trace": "the XLA profiler: the port's CLI profiles with `run --profile`",
    "ops/testing.py:emulate_kernel": _GRID,
    "ops/testing.py:emulate_pallas_grid": _GRID,
    "ops/__init__.py:pallas_enabled": _PALLAS,
    "ops/__init__.py:pallas_interpret": _PALLAS,
    "ops/__init__.py:pallas_mode": _PALLAS,
    **{f"parallel/{mod}:{name}": _GSPMD
       for mod in ("__init__.py", "mesh.py")
       for name in ("replicated", "row_sharding", "vec_sharding", "domain_spec")
       if not (mod == "__init__.py" and name == "domain_spec")},
    **{f"hash/merkle.py:{name}": _PLANAR
       for name in ("planar_for_domain", "PLANAR_MIN", "PLANAR_DOMAIN_MIN", "is_planar")},
    **{f"ntt/core.py:NttPlan.{name}": _STAGES for name in ("bitrev", "twiddles")},
    **{f"ops/ntt_kernel.py:FourStepPlan.{name}": _STAGES
       for name in ("tw1", "tw2", "twp1", "twp2", "br1", "br2")},
    "parallel/fri_sharded.py:fold_sharded(inv2_mont)":
        "1/2 is a constant of the field: the fold kernel takes it from the prime",
    "protocol/fused.py:unpack_out(mesh)":
        "the fetched vector is whole on every process (Mesh.replicate): unpacking reads no mesh",
}
# What NOT_PORTED may hold at all: whole modules, or names of one module
_MAY_NOT_PORT = {
    "runtime.py": None,
    "ops/testing.py": None,
    "ops/__init__.py": {"pallas_enabled", "pallas_interpret", "pallas_mode"},
    "parallel/__init__.py": {"replicated", "row_sharding", "vec_sharding", "domain_spec"},
    "parallel/mesh.py": {"replicated", "row_sharding", "vec_sharding", "domain_spec"},
    "hash/merkle.py": {"planar_for_domain", "PLANAR_MIN", "PLANAR_STOP", "PLANAR_DOMAIN_MIN",
                       "is_planar"},
    "ntt/core.py": {"NttPlan.bitrev", "NttPlan.twiddles"},
    "ops/ntt_kernel.py": {f"FourStepPlan.{t}" for t in ("tw1", "tw2", "twp1", "twp2", "br1", "br2")},
    "parallel/fri_sharded.py": {"fold_sharded(inv2_mont)"},
    "protocol/fused.py": {"unpack_out(mesh)"},
}


def public_names(path: Path) -> list:
    """Top-level public functions, classes, UPPER_CASE constants and
    ``__all__`` of one source file, without imported names."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            if not node.name.startswith("_"):
                out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for target in targets:
                for n in ast.walk(target):
                    if not isinstance(n, ast.Name):
                        continue
                    if n.id == "__all__":
                        out |= {e.value for e in node.value.elts}
                    elif n.id.isupper() and not n.id.startswith("_"):
                        out.add(n.id)
    return sorted(out)


def class_members(node: ast.ClassDef) -> list:
    """The public members of a class body: methods (properties, class and
    static methods among them), UPPER_CASE class attributes and annotated
    fields."""
    out = set()
    for item in node.body:
        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if not item.name.startswith("_"):
                out.add(item.name)
        elif isinstance(item, (ast.Assign, ast.AnnAssign)):
            targets = item.targets if isinstance(item, ast.Assign) else [item.target]
            for target in targets:
                for n in ast.walk(target):
                    if (isinstance(n, ast.Name) and not n.id.startswith("_")
                            and (n.id.isupper() or isinstance(item, ast.AnnAssign))):
                        out.add(n.id)
    return sorted(out)


def parameters(node) -> list:
    """The parameter names of a `def`, without self and cls."""
    a = node.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
    return [n for n in names if n not in ("self", "cls")]


def _covered(key: str) -> bool:
    return key in RENAMED or key in NOT_PORTED


def walk(path: Path) -> list:
    """The cases of one source file: its public names, the members of its
    public classes and the parameters of its public functions and methods,
    skipping what an entry of a name above them covers."""
    rel = path.relative_to(JAX_PKG).as_posix()
    out = [f"{rel}:{name}" for name in public_names(path)]
    for node in ast.parse(path.read_text()).body:
        if node.name.startswith("_") if hasattr(node, "name") else True:
            continue
        if _covered(f"{rel}:{node.name}"):
            continue
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out += [f"{rel}:{node.name}({a})" for a in parameters(node)]
        elif isinstance(node, ast.ClassDef):
            members = class_members(node)
            out += [f"{rel}:{node.name}.{m}" for m in members]
            for item in node.body:
                if (isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and (item.name in members or item.name == "__init__")
                        and not _covered(f"{rel}:{node.name}.{item.name}")):
                    out += [f"{rel}:{node.name}.{item.name}({a})" for a in parameters(item)]
    return out


CASES = [key for path in sorted(JAX_PKG.rglob("*.py")) for key in walk(path)]


def port_module(rel: str):
    """The port's module at the relative path `rel`, or None."""
    if not (ROOT / "zkstark_tpu_torch" / rel).exists():
        return None
    dotted = rel[: -len(".py")].replace("/", ".")
    if dotted == "__init__":
        return importlib.import_module("zkstark_tpu_torch")
    dotted = dotted.removesuffix(".__init__")
    return importlib.import_module(f"zkstark_tpu_torch.{dotted}")


def _fields(cls) -> set:
    """The instance fields a class declares: dataclass and NamedTuple
    fields, slots and annotations, over its bases."""
    out = set(getattr(cls, "_fields", ()))
    if dataclasses.is_dataclass(cls):
        out |= {f.name for f in dataclasses.fields(cls)}
    for base in cls.__mro__:
        out |= set(getattr(base, "__slots__", ())) | set(getattr(base, "__annotations__", {}))
    return out


def port_has(key: str) -> bool:
    """Whether the port has the name, member or parameter of `key`."""
    rel, name = key.split(":")
    name, _, param = name.partition("(")
    mod = port_module(rel)
    if mod is None:
        return False
    owner, _, member = name.rpartition(".")
    obj = mod
    if owner:
        obj = getattr(mod, owner, None)
        if not isinstance(obj, type):
            return False
        if not param and member in _fields(obj):
            return True
    obj = getattr(obj, member, None)
    if obj is None:
        return False
    if not param:
        return True
    try:
        return param[:-1] in inspect.signature(obj).parameters
    except (TypeError, ValueError):
        return False


@pytest.mark.parametrize("key", CASES)
def test_name_has_a_counterpart(key):
    assert not (key in RENAMED and key in NOT_PORTED), key
    if key in NOT_PORTED:
        reason = NOT_PORTED[key]
        assert reason.strip() and "\n" not in reason
        assert not port_has(key), f"{key} is ported: take it out of NOT_PORTED"
    elif key in RENAMED:
        target, _ = RENAMED[key]
        assert port_has(target), f"{key} → {target}, which the port does not have"
        assert not port_has(key), f"{key} is ported under its own name: take it out of RENAMED"
    else:
        assert port_has(key), f"{key} has no counterpart, no RENAMED and no NOT_PORTED entry"


def test_maps_name_only_jax_names():
    assert set(RENAMED) <= set(CASES) and set(NOT_PORTED) <= set(CASES)


@pytest.mark.parametrize("key", sorted(NOT_PORTED))
def test_not_ported_holds_only_what_has_no_meaning_on_the_card(key):
    rel, name = key.split(":")
    assert rel in _MAY_NOT_PORT
    assert _MAY_NOT_PORT[rel] is None or name in _MAY_NOT_PORT[rel]


@pytest.mark.parametrize("key", sorted(RENAMED))
def test_renamed_entries_name_their_equality_test(key):
    _, test = RENAMED[key]
    file, func = test.split("::")
    tree = ast.parse((ROOT / "tests" / file).read_text())
    assert func in {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}, test


def test_walk_sees_the_whole_package():
    modules = {key.split(":")[0] for key in CASES}
    assert {"field/fp.py", "hash/merkle.py", "ops/sha256_kernel.py", "protocol/prover.py",
            "native.py", "runtime.py", "ops/testing.py"} <= modules
    assert len(CASES) >= 240
    # class members and parameter names, not only top-level names
    assert {"field/fp.py:Field.mont_mul", "field/fp.py:Field.powers_iota(scale)",
            "hash/merkle.py:MerkleTree.num_leaves", "protocol/checkpoint.py:ResumableProver.PHASES",
            "protocol/prover.py:prove(channel)", "ntt/core.py:NttPlan.bitrev"} <= set(CASES)
    assert not any(k.startswith("runtime.py:") and "(" in k for k in CASES)  # NOT_PORTED names
    assert len(CASES) == len(set(CASES))


def test_mesh_device_is_backend():
    """`make_mesh(device=)` and `make_host_chip_mesh(device=)` take the
    JAX functions' `backend=`: the same shapes and axis names on the CPU."""
    import jax

    from zkstark_tpu.parallel import mesh as jmesh
    from zkstark_tpu_torch.parallel import mesh

    for n in sorted({1, min(2, len(jax.devices("cpu")))}):
        want = jmesh.make_mesh(n, backend="cpu")
        got = mesh.make_mesh(n, device="cpu")
        assert got.axis_names == tuple(want.axis_names) and got.shape == dict(want.shape)
    want = jmesh.make_host_chip_mesh(1, 1, backend="cpu")
    got = mesh.make_host_chip_mesh(1, 1, device="cpu")
    assert got.axis_names == tuple(want.axis_names) and got.shape == dict(want.shape)


# ---------------------------------------------------------------------------
# the equality tests the maps above name, and the other names added beside them
# ---------------------------------------------------------------------------


def _rand_mont(fld, shape, seed):
    rng = np.random.default_rng(seed)
    return fld.host_to_mont(rng.integers(0, fld.p, shape, dtype=np.uint64))


@pytest.mark.parametrize("p", [3221225473, 2013265921])
@pytest.mark.parametrize("k", [128, 256])
def test_dft_matmul_is_limb_dft_rows(p, k):
    """`dft_matmul` along the last axis of (3, k) is the length-k limb DFT of
    each row."""
    from zkstark_tpu.field import fp as jfp
    from zkstark_tpu.ops import mxu_ntt
    from zkstark_tpu_torch.field import fp
    from zkstark_tpu_torch.ops import limb_dft

    fld = fp.field_for(p)
    w = fld.subgroup_generator(k)
    x = _rand_mont(fld, (3, k), seed=k)
    want = np.asarray(mxu_ntt.dft_matmul(jnp.asarray(x), k, w, jfp.field_for(p), contract_axis=1))
    got = fp.to_host(limb_dft.limb_dft_rows(fp.from_host(x, "cpu"), w, fld))
    np.testing.assert_array_equal(got, want)


def test_max_row_is_max_cols_size():
    from zkstark_tpu.ops import ntt_kernel as jk
    from zkstark_tpu_torch.ops import ntt_kernel

    assert ntt_kernel.MAX_ROW == jk.MAX_COLS_SIZE
    assert ntt_kernel.MIN_FOURSTEP == jk.MIN_FOURSTEP


@pytest.mark.parametrize("n_queries", [1, 3])
def test_decommit_writes_fused_decommit_bytes(n_queries):
    """The port's `decommit` commits what the JAX `fused_decommit` commits,
    on random openings of stark-101's shapes, from the same channel state."""
    from zkstark_tpu.protocol import prover as jpr
    from zkstark_tpu.protocol.config import StarkConfig as JaxConfig
    from zkstark_tpu.transcript import Channel as JaxChannel
    from zkstark_tpu_torch.protocol import prover
    from zkstark_tpu_torch.protocol.config import StarkConfig
    from zkstark_tpu_torch.protocol.openings import opening_shapes
    from zkstark_tpu_torch.transcript import Channel

    cfg, jcfg = StarkConfig(n_queries=n_queries), JaxConfig(n_queries=n_queries)
    rng = np.random.default_rng(n_queries)

    def rand(shape):
        return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)

    out = {k: [rand(s) for s in v] if isinstance(v, list) else rand(v)
           for k, v in opening_shapes(cfg).items()}
    queries = rng.integers(0, cfg.query_range, n_queries).tolist()
    jch, ch = JaxChannel(), Channel()
    for c in (jch, ch):
        c.commit_hash(hashlib.sha256(b"prefix").digest())
    art = SimpleNamespace()
    jpr.fused_decommit(jcfg, jch, art, out, queries)
    proof = prover.decommit(cfg, ch, out, queries)
    assert (proof.state, proof.data) == jch.finalize()
    assert art.query_indices == queries


@pytest.mark.parametrize("kw", [{}, dict(trace_len=63, secret=31415),
                                dict(trace_len=255, secret=7, n_queries=3, blowup=4)])
def test_alt_field_config(kw):
    from zkstark_tpu.protocol.config import alt_field_config as jalt
    from zkstark_tpu_torch.protocol.config import alt_field_config, from_reference

    cfg = alt_field_config(**kw)
    assert cfg == from_reference(jalt(**kw))
    assert cfg.field.p == 2013265921


@pytest.mark.parametrize("layer", [0, 1, 5, 9])
@pytest.mark.parametrize("alt", [False, True])
def test_fri_layer_constants(layer, alt):
    from zkstark_tpu.protocol import prover as jpr
    from zkstark_tpu.protocol.config import STARK101 as JSTARK101
    from zkstark_tpu.protocol.config import alt_field_config as jalt
    from zkstark_tpu_torch.protocol import prover
    from zkstark_tpu_torch.protocol.config import STARK101, alt_field_config

    cfg, jcfg = (alt_field_config(), jalt()) if alt else (STARK101, JSTARK101)
    got = prover.fri_layer_constants(cfg, layer)
    want = np.asarray(jpr.fri_layer_constants(jcfg, layer))
    assert got.dtype == np.uint32 and got.shape == ((cfg.eval_domain >> layer) // 2,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [1 << 14, 1 << 15])
@pytest.mark.parametrize("inverse", [False, True])
def test_fourstep_plan(n, inverse):
    """The port's plan holds the JAX plan's U and V, transposed."""
    from zkstark_tpu.ops import ntt_kernel as jk
    from zkstark_tpu_torch.field import fp
    from zkstark_tpu_torch.ops import ntt_kernel

    fld = fp.FIELD101
    w = fld.subgroup_generator(n)
    scale = fld.mont_scalar(pow(n, fld.p - 2, fld.p)) if inverse else None
    plan = ntt_kernel._fourstep_constants(n, w, scale, fld)
    want = jk._fourstep_constants(n, w, scale)
    assert isinstance(plan, ntt_kernel.FourStepPlan)
    assert (plan.n1, plan.n2) == (want.n1, want.n2)
    np.testing.assert_array_equal(plan.ut, np.asarray(want.u).T)
    np.testing.assert_array_equal(plan.vt, np.asarray(want.v).T)


@pytest.fixture(scope="module")
def native_lib():
    if shutil.which("g++") is None:
        pytest.skip("native toolchain unavailable")
    from zkstark_tpu_torch import native

    return native.native()


def test_channel_commit_matches_python(native_lib):
    from zkstark_tpu_torch.native import channel_commit
    from zkstark_tpu_torch.transcript import Channel

    ch = Channel()
    payload = b"hello zkstark" * 3
    assert channel_commit(ch.state, payload) == hashlib.sha256(ch.state + payload).digest()
    ch.commit_bytes(payload)
    assert channel_commit(b"\x00" * 32, payload) == ch.state


def test_channel_draw_matches_python(native_lib):
    from zkstark_tpu_torch.native import channel_draw
    from zkstark_tpu_torch.transcript import Channel

    ch = Channel()
    ch.commit_hash(hashlib.sha256(b"seed").digest())
    for _ in range(4):
        before = ch.state
        draw = ch.get_u32()
        assert channel_draw(before) == (ch.state, draw)
