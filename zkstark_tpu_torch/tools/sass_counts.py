"""Opcode counts of the built CUDA kernels, read from their SASS.

    python -m zkstark_tpu_torch.tools.sass_counts [--dump DIR]

Builds the kernel library if it is not built yet (``ops/_build.py``), runs
``cuobjdump -sass`` on it and prints one JSON line per kernel: the number of
machine ops, the commonest opcodes, and every loop (a backward branch and
its target) with its length, its opcodes and its shared-memory loads and
stores. A fully unrolled kernel (the SHA-256 pair) shows its count per hash
as the whole kernel's; the NTT row kernel shows its count per radix-8 task as
the loop with 8 ``LDS`` and 8 ``STS`` (12 butterflies). The Pease kernel is
unrolled over its passes: an instance's whole count is one thread's, which
runs m/4 / threads radix-4 tasks (4 butterflies each) in each of log2(m)/2
passes (``ntt_rows_pease_kernel<12,1>``, bit-reversed order out: 512
threads, 2 tasks × 6 passes, 48 butterflies; ``<12,0>``, natural order out,
adds its store loop). The FRI fold's vector instance (``fri_fold_kernel<1>``) counts
four outputs, the chain kernel one boundary with its draw loop. ``--dump
DIR`` also writes each kernel's SASS to ``DIR/<kernel>.sass``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

_FUNCTION = re.compile(r"^\s*Function : (\S+)")
_INSTR = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T\d]+\s+)?([A-Z0-9_.]+)([^;]*);")
_TARGET = re.compile(r"\b0x([0-9a-f]+)\b")


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "cuobjdump"
    if cand.exists():
        return str(cand)
    raise RuntimeError("cuobjdump not found: it comes with the CUDA toolkit")


def parse(sass: str) -> dict:
    """{mangled function name: [(address, opcode, operands), ...]}."""
    out, cur = {}, None
    for line in sass.splitlines():
        fn = _FUNCTION.match(line)
        if fn:
            cur = out.setdefault(fn.group(1), [])
            continue
        ins = _INSTR.match(line)
        if ins and cur is not None:
            cur.append((int(ins.group(1), 16), ins.group(2), ins.group(3)))
    return out


def _family(opcode: str) -> str:
    return opcode.split(".")[0]


def summarize(instrs: list) -> dict:
    ops = Counter(_family(op) for _, op, _ in instrs)
    loops = []
    for addr, op, rest in instrs:
        if _family(op) != "BRA":
            continue
        target = _TARGET.search(rest)
        if not target or int(target.group(1), 16) > addr:
            continue
        start = int(target.group(1), 16)
        body = [i for i in instrs if start <= i[0] <= addr]
        fam = Counter(_family(o) for _, o, _ in body)
        loops.append({"from": hex(start), "to": hex(addr), "ops": len(body),
                      "LDS": fam["LDS"], "STS": fam["STS"], "top": dict(fam.most_common(8))})
    return {"ops": len(instrs), "top": dict(ops.most_common(10)), "loops": loops}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dump", metavar="DIR", help="write each kernel's SASS into DIR")
    args = ap.parse_args(argv)
    from zkstark_tpu_torch.ops import _build

    _build.kernels()
    _, key = _build._sources()
    so = _build.BUILD_DIR / f"libzkstark_kernels_{key}.so"
    sass = subprocess.run([_cuobjdump(), "-sass", str(so)], check=True, capture_output=True,
                          text=True).stdout
    if args.dump:
        Path(args.dump).mkdir(parents=True, exist_ok=True)
    for name, instrs in parse(sass).items():
        short = next((k for k in ("ntt_rows_pease_kernel", "ntt_rows_kernel", "transpose_kernel",
                                  "sha256_leaf", "sha256_node", "sha256_tree_tail",
                                  "fp_check_kernel", "empty_kernel",
                                  "fs_chain_kernel", "fri_fold_kernel", "limb_dft_rows_kernel",
                                  "composition_kernel") if k in name),
                     name)
        # a template instance: its arguments
        instance = re.search(r"(?:kernel|leaf|node)I((?:L[ib]\d+E)+)E", name)
        if instance:
            short += f"<{','.join(re.findall(r'L[ib](\d+)E', instance.group(1)))}>"
        print(json.dumps({"kernel": short, **summarize(instrs)}), flush=True)
        if args.dump:
            lines = [f"/*{a:04x}*/ {op}{rest};" for a, op, rest in instrs]
            (Path(args.dump) / f"{short}.sass").write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
