"""A process group of one process: the mesh's collectives go through
`torch.distributed` (gloo here; ``test_torch_cuda_proofs.py`` runs the same
on NCCL), not through the local mesh's device copies, and the proofs are the
solo ones.

The worker is this file run as a script in a fresh process (it imports no
JAX): it starts the group itself (world size 1, rank 0, a free localhost
port), as a one-card run would, and `initialize_distributed` accepts it.
"""

import json
import socket
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SECRET = 31415


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_worker(module: str, worker: str, timeout: int) -> dict:
    """`module.worker(port)` in a fresh process, given a free localhost port:
    the dict it returns, read from the JSON of its last line."""
    code = (f"import sys; sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'tests')!r}]; "
            f"import json, {module} as t; print(json.dumps(t.{worker}({_free_port()})))")
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=timeout)
    assert run.returncode == 0, run.stderr[-4000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


def _worker(port: int) -> dict:
    import torch.distributed as dist

    from zkstark_tpu_torch.parallel import initialize_distributed, make_host_chip_mesh, make_mesh
    from zkstark_tpu_torch.protocol.air import FIBONACCI_SQ
    from zkstark_tpu_torch.protocol.config import StarkConfig
    from zkstark_tpu_torch.protocol.prover import prove

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    assert initialize_distributed() == 1
    trace = FIBONACCI_SQ.trace(63, SECRET)
    cfg = StarkConfig(trace_len=63, boundary_first=int(trace[0]), boundary_last=int(trace[-1]))
    solo = prove(cfg, SECRET, device="cpu")
    res = {}
    for label, mesh in (("S=1", make_mesh(device="cpu")), ("S=2", make_mesh(2, device="cpu")),
                        ("1x2", make_host_chip_mesh(1, 2, device="cpu"))):
        assert not mesh.is_local and mesh.n_processes == 1
        got = prove(cfg, SECRET, device="cpu", mesh=mesh)
        res[label] = dict(same=(got.state, got.data) == (solo.state, solo.data),
                          moved=sum(mesh.bytes_moved.values()))
    dist.destroy_process_group()
    return res


def test_group_of_one_proves_the_solo_bytes():
    res = run_worker("test_torch_group_of_one", "_worker", 300)
    assert all(r["same"] for r in res.values()), res
    assert res["S=2"]["moved"] > 0 and res["1x2"]["moved"] > 0
