"""Build and load the CUDA kernels of ``csrc/``, and the host C++ (`gxx`).

At first use, ``nvcc`` compiles every ``csrc/*.cu`` for Hopper (sm_90a), one
process per source, all started together, and links the objects into one
shared library with a plain C interface, ``build/zkstark_tpu_torch/`` under
the repository root, named by a hash of the sources and flags. The
library is loaded with ctypes; every pointer and the stream pass as
``c_void_p``. Each C entry point returns ``cudaGetLastError()`` after its
launch, and `check` raises on anything but 0. There is no fallback: a build
or launch failure is an exception.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from zkstark_tpu_torch import tracing

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "zkstark_tpu_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_U32 = ctypes.c_uint32
_INT = ctypes.c_int
_SIGNATURES = {
    # (vals, out, n, stream)
    "zk_sha256_leaf": (_P, _P, _I64, _P),
    # (vals, out, trees, log_n, width, stream)
    "zk_sha256_leaf_rows": (_P, _P, _I64, _INT, _INT, _P),
    # (children, out, k, stream)
    "zk_sha256_node": (_P, _P, _I64, _P),
    # (vals, out planes, n, stream)
    "zk_sha256_leaf_planes": (_P, _P, _I64, _P),
    # (left planes, right planes, out planes, k, stride, stream)
    "zk_sha256_node_planes": (_P, _P, _P, _I64, _I64, _P),
    # (in, out, trees, t, from_values, stream)
    "zk_sha256_tree_tail": (_P, _P, _I64, _INT, _INT, _P),
    # (x, out, pass_tw, log_m, batch, valid, w8, w4, w8^3,
    #  pre: a, b, shift, col_stride, row_stride, post: the same five,
    #  ut, vt, log2(vblk), scale, has_scale, period - 1, p, p_inv_neg, stream)
    "zk_ntt_rows": (
        _P, _P, _P, _INT, _I64, _INT, _U32, _U32, _U32,
        _P, _P, _INT, _U32, _U32, _P, _P, _INT, _U32, _U32,
        _P, _P, _INT, _U32, _INT, _U32, _U32, _U32, _P,
    ),
    # (src, dst, rows, cols, elem, valid, batch, brev, stream)
    "zk_transpose": (_P, _P, _INT, _INT, _INT, _I64, _I64, _INT, _P),
    # (x, out, tw, log_m, batch, valid,
    #  pre: a, b, shift, col_stride, row_stride, post: the same five,
    #  ut, vt, log2(vblk), scale, has_scale, period - 1, bitrev, p, p_inv_neg, stream)
    "zk_ntt_rows_pease": (
        _P, _P, _P, _INT, _I64, _INT,
        _P, _P, _INT, _U32, _U32, _P, _P, _INT, _U32, _U32,
        _P, _P, _INT, _U32, _INT, _U32, _INT, _U32, _U32, _P,
    ),
    # (state_in, state_out, digest, digest_stride, word, word_stride, n_draws, draws,
    #  draws_stride, mont, mod, mod_stride, query_range, r2, p, p_inv_neg, chains, stream)
    "zk_fs_chain": (_P, _P, _P, _I64, _P, _I64, _INT, _P, _I64, _P, _P, _I64, _U32, _U32, _U32,
                    _U32, _I64, _P),
    # (evals, beta, geo_a, geo_b, geo_shift, folded, res, batch, half, scale, inv2,
    #  p, p_inv_neg, stream)
    "zk_fri_fold": (_P, _P, _P, _P, _INT, _P, _P, _I64, _I64, _U32, _U32, _U32, _U32, _P),
    # (x, out, af1, af2, tw, log_k1, log_k2, batch, valid,
    #  pre: a, b, shift, col_stride, row_stride, post: the same five,
    #  ut, vt, log2(vblk), scale, has_scale, period - 1, p, p_inv_neg, stream)
    "zk_limb_dft_rows": (
        _P, _P, _P, _P, _P, _INT, _INT, _I64, _INT,
        _P, _P, _INT, _U32, _U32, _P, _P, _INT, _U32, _U32,
        _P, _P, _INT, _U32, _INT, _U32, _U32, _U32, _P,
    ),
    # (f_eval, halo, halo_len, inv_dens, alphas, program, program_words, shifts_by_4,
    #  geo_a, geo_b, geo_shift, offset, cp_eval, cp_res, batch, len, start, d, p,
    #  p_inv_neg, width, stream)
    "zk_composition": (
        _P, _P, _I64, _P, _P, _P, _INT, _INT, _P, _P, _INT, _U32, _P, _P, _I64, _I64, _I64,
        _I64, _U32, _U32, _I64, _P,
    ),
    # (in, out, n, p, p_inv_neg, stream)
    "zk_from_mont": (_P, _P, _I64, _U32, _U32, _P),
    # (c0, out, geo_a, geo_b, geo_shift, g, batch, n, p, p_inv_neg, stream)
    "zk_endpoint_fix": (_P, _P, _P, _P, _INT, _U32, _I64, _I64, _U32, _U32, _P),
    # (words, n_words, ztab, zmask, geo_a, geo_b, geo_shift, offset, one, out, d,
    #  p, p_inv_neg, stream); words is host memory
    "zk_constants": (_P, _INT, _INT, _INT, _P, _P, _INT, _U32, _U32, _P, _I64, _U32, _U32, _P),
    # (words, n_words, n_segs, batch, stream); words is host memory
    "zk_openings": (_P, _INT, _INT, _INT, _P),
    # (out, n, table a, table b, shift, p, p_inv_neg, stream)
    "zk_powers": (_P, _I64, _P, _P, _INT, _U32, _U32, _P),
    # (a, b, out, n, p, p_inv_neg, stream)
    "zk_fp_check": (_P, _P, _P, _I64, _U32, _U32, _P),
    # (stream)
    "zk_empty": (_P,),
}

build_log = ""  # nvcc's output of that run (-Xptxas -v: registers, spills)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources() -> tuple[list[Path], str]:
    cu = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return cu, h.hexdigest()[:16]


def _compile(cu: list, so: Path) -> str:
    """nvcc -c for every source in parallel, then one link into `so`;
    returns nvcc's output (ptxas: registers, spills) and raises on failure."""
    nvcc = _nvcc()
    obj_dir = so.with_name(f"{so.stem}.{os.getpid()}.obj")
    obj_dir.mkdir(parents=True, exist_ok=True)
    try:
        objs = [obj_dir / f"{src.stem}.o" for src in cu]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            )
            for src, obj in zip(cu, objs)
        ]
        log, failed = "", []
        for src, proc in zip(cu, procs):
            out, _ = proc.communicate()
            log += out
            if proc.returncode != 0:
                failed.append(f"{src.name} ({proc.returncode})")
        if failed:
            raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n{log}")
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        res = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
            capture_output=True,
            text=True,
        )
        log += res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{log}")
        os.replace(tmp, so)
        return log
    finally:
        shutil.rmtree(obj_dir, ignore_errors=True)


@functools.lru_cache(maxsize=1)
def kernels() -> ctypes.CDLL:
    """The loaded kernel library, compiled first if this source hash has no
    library yet (the spans `library.build`, nvcc's wall time, and
    `library.load`)."""
    global build_log
    cu, key = _sources()
    so = BUILD_DIR / f"libzkstark_kernels_{key}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tracing.span("library.build"):
            build_log = _compile(cu, so)
    with tracing.span("library.load"):
        lib = ctypes.CDLL(str(so))
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(args)
            fn.restype = ctypes.c_int
        lib.zk_cuda_error_string.argtypes = [ctypes.c_int]
        lib.zk_cuda_error_string.restype = ctypes.c_char_p
    return lib


def gxx(src: Path, stem: str) -> Path:
    """The shared library ``g++ -O3 -fPIC -shared`` builds from the C++ file
    `src`, `<stem>_<hash of the source>.so` in `BUILD_DIR`, built first if
    it is not there. A missing compiler or a failed build raises."""
    code = src.read_bytes()
    so = BUILD_DIR / f"{stem}_{hashlib.sha256(code).hexdigest()[:16]}.so"
    if so.exists():
        return so
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError(f"no C++ compiler (g++) to build {src.name}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, "-O3", "-std=c++17", "-fPIC", "-shared", "-o", str(tmp), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed for {src.name}:\n{res.stdout}{res.stderr}")
    os.replace(tmp, so)
    return so


def check(rc: int, what: str) -> None:
    if rc != 0:
        msg = kernels().zk_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream(t: torch.Tensor) -> int:
    """The handle of the current stream on t's device (the raw handle, as
    torch's own generated code reads it: no Stream object is built)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def out_tensor(out: torch.Tensor | None, shape: tuple, like: torch.Tensor, what: str,
               align: int = 4) -> torch.Tensor:
    """A wrapper's `out=` argument, checked to be a contiguous uint32 tensor
    of `shape` on `like`'s device (aligned to `align` bytes on a card), or a
    new one if None."""
    if out is None:
        return torch.empty(shape, dtype=torch.uint32, device=like.device)
    if (out.dtype != torch.uint32 or tuple(out.shape) != tuple(shape) or not out.is_contiguous()
            or out.device != like.device or (out.is_cuda and out.data_ptr() % align)):
        raise ValueError(f"{what}: out= must be a contiguous uint32 {tuple(shape)} tensor on "
                         f"{like.device}, {align}-byte aligned")
    return out


def require(t: torch.Tensor, what: str, ndim: int) -> None:
    """The checks every kernel wrapper makes on a field tensor."""
    if t.dtype != torch.uint32:
        raise TypeError(f"{what}: needs torch.uint32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{what}: needs {ndim}-D input, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: needs a contiguous tensor")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {t.device}")
