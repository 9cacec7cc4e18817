#!/usr/bin/env python3
"""Instruction counts of the port's CUDA kernels, from their SASS.

    python3 tools/torch_sass_count.py SOURCE.cu [SOURCE.cu ...]

Compiles each source to a cubin with the flags of
``orion_kmer_tpu_torch/_kernels.py`` (sm_90a, ``-Xptxas -v``), disassembles
it with ``cuobjdump -sass`` and prints, per kernel, its instruction count
(NOPs left out), the length of its largest loop body (the instructions
between a backward branch and its target) and ptxas's registers and spills.
Needs ``nvcc`` and ``cuobjdump`` (the CUDA toolkit), so it runs on the
machine with the card; the cubins go to a temporary directory.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from orion_kmer_tpu_torch._kernels import NVCC_FLAGS, _nvcc, parse_ptxas  # noqa: E402

_INSN = re.compile(r"^\s*/\*([0-9a-f]+)\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"BRA\s+(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))")


def _functions(sass: str):
    """(mangled name, [(address, text)], {label: address}) per function."""
    funcs = []
    pending = []
    for line in sass.splitlines():
        if m := re.search(r"Function : (\S+)", line):
            funcs.append((m.group(1), [], {}))
            pending = []
        elif not funcs:
            continue
        elif m := _LABEL.match(line):
            pending.append(m.group(1))
        elif m := _INSN.match(line):
            addr = int(m.group(1), 16)
            funcs[-1][1].append((addr, m.group(2)))
            for label in pending:
                funcs[-1][2][label] = addr
            pending = []
    return funcs


def _opcode(text: str) -> str:
    toks = text.split()
    return toks[1] if toks[0].startswith("@") and len(toks) > 1 else toks[0]


def count(insns, labels):
    """(instructions without NOPs, instructions of the largest loop body).
    cuobjdump writes branch targets as addresses or as labels."""
    real = [(a, t) for a, t in insns if _opcode(t) != "NOP"]
    loop = 0
    for addr, text in insns:
        m = _TARGET.search(text)
        if not m:
            continue
        start = labels.get(m.group(1), addr) if m.group(1) else int(m.group(2), 16)
        if start < addr:  # a backward branch closes a loop
            loop = max(loop, sum(1 for a, _ in real if start <= a <= addr))
    return len(real), loop


def main() -> int:
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    nvcc = _nvcc()
    cuobjdump = shutil.which("cuobjdump") or str(Path(nvcc).parent / "cuobjdump")
    filt = shutil.which("cu++filt") or str(Path(nvcc).parent / "cu++filt")
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        for src in sys.argv[1:]:
            cubin = Path(tmp) / (Path(src).stem + ".cubin")
            proc = subprocess.run([nvcc, *NVCC_FLAGS, "-cubin", "-o", str(cubin), src],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise SystemExit(f"nvcc failed for {src}:\n{proc.stderr}")
            ptxas = {k.pop("name"): k for k in parse_ptxas(proc.stderr)}
            sass = subprocess.run([cuobjdump, "-sass", str(cubin)], capture_output=True, text=True, check=True).stdout
            for name, insns, labels in _functions(sass):
                total, loop = count(insns, labels)
                pretty = subprocess.run([filt, name], capture_output=True, text=True).stdout.strip() or name
                out.append({"source": src, "kernel": pretty, "instructions": total, "largest_loop_body": loop,
                            **ptxas.get(name, {})})
    for row in out:
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
