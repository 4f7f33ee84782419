"""The port and its card tests import neither JAX nor `zkstark_tpu`.

The card tests (`tests/test_torch_cuda*.py`) run with ``--noconftest`` on a
card machine that may have no JAX, so they, and `test_torch_group_of_one.py`,
whose process launcher they share, are held to the package's rule. A
`sys.modules` check cannot show this where JAX is preloaded, so every import
statement is read from the source with `ast`.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = (sorted((ROOT / "zkstark_tpu_torch").rglob("*.py"))
         + sorted((ROOT / "tests").glob("test_torch_cuda*.py"))
         + [ROOT / "tests" / "test_torch_group_of_one.py"])


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "zkstark_tpu")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant) and _forbidden(str(arg.value)):
                bad.append(arg.value)
    assert not bad, f"{path.name} imports {bad}"


def test_package_is_covered():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert "zkstark_tpu_torch/protocol/prover.py" in names
    assert "zkstark_tpu_torch/ops/ntt_kernel.py" in names
    assert "zkstark_tpu_torch/__main__.py" in names
    assert "zkstark_tpu_torch/protocol/checkpoint.py" in names
    assert "zkstark_tpu_torch/tools/prove_big.py" in names
    for new in ("transcript/device_channel.py", "ops/fs_chain.py", "ops/fri_fold.py",
                "protocol/fused.py", "protocol/batch.py"):
        assert f"zkstark_tpu_torch/{new}" in names
    for new in ("__init__.py", "mesh.py", "ntt_sharded.py", "merkle_sharded.py",
                "fri_sharded.py", "pipeline.py"):
        assert f"zkstark_tpu_torch/parallel/{new}" in names
    for new in ("ops/openings.py", "ops/elementwise.py", "ops/constants.py",
                "tools/scaling_bench.py"):
        assert f"zkstark_tpu_torch/{new}" in names
    for card in ("test_torch_cuda.py", "test_torch_cuda_graph.py", "test_torch_cuda_proofs.py",
                 "test_torch_group_of_one.py"):
        assert f"tests/{card}" in names
    assert len(names) >= 41
