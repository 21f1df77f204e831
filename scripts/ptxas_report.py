#!/usr/bin/env python3
"""Registers, spills and tensor-core instructions of every compiled kernel
of the port, on a machine with ``nvcc``.

    python3 scripts/ptxas_report.py

Builds ``src/repro_torch/kernels/csrc`` with the port's own flags plus
``-Xptxas=-v`` into ``build/kernels_ptxas`` (the port's ``build/kernels``
is left alone); the ptxas output goes to this process's standard output
as the build runs. Then it reads the built library's SASS with
``cuobjdump -sass`` and prints one line per kernel instantiation: its
registers, spill stores and loads (bytes, from ptxas) and its count of
tensor-core instructions (``HMMA``, or ``HGMMA`` for ``wgmma``), so a
reader can see which bodies run their products on the tensor cores. Ends
with a count of instantiations, spilling ones and ones with tensor-core
instructions, then the MLA decode kernels' and the int8 decode split
passes' own counts, and the rmsnorm instantiations' registers and spills
one by one; it exits 1 unless every bf16 MLA split body has tensor-core
instructions, no MLA instantiation spills, the int8 split passes are
there and none of them spills, and the rmsnorm instantiations are there
and none of them spills.
"""
from __future__ import annotations

import contextlib
import io
import os
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
BUILD = ROOT / "build" / "kernels_ptxas"


def ptxas_table(text: str) -> dict:
    """{mangled name: [registers, spill stores, spill loads]} from ptxas -v."""
    table, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            table[name] = [0, 0, 0]
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            table[name][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            table[name][0] = int(m.group(1))
    return table


def tensor_ops(library: pathlib.Path) -> dict:
    """{mangled name: HMMA + HGMMA instructions} from cuobjdump -sass."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name and re.search(r"\bH(G)?MMA\b", line):
            counts[name] += 1
    return counts


def demangle(names) -> dict:
    tool = shutil.which("c++filt")
    if not tool:
        return {n: n for n in names}
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True).stdout.splitlines()
    return dict(zip(names, out)) if len(out) == len(names) else {
        n: n for n in names}


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.build import load_kernels

    # ninja writes the compiler's output to file descriptor 1
    with tempfile.TemporaryFile(mode="w+") as log:
        saved = os.dup(1)
        os.dup2(log.fileno(), 1)
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                ext = load_kernels(BUILD, extra_cuda_flags=("-Xptxas=-v",),
                                   verbose=True)
        finally:
            os.dup2(saved, 1)
            os.close(saved)
            log.seek(0)
            text = log.read()
            print(text, flush=True)
    table = ptxas_table(text)
    ops = tensor_ops(pathlib.Path(ext.__file__))
    names = demangle(sorted(table))
    spilling = tensor = 0
    for name in sorted(table):
        regs, st, ld = table[name]
        n_ops = ops.get(name, 0)
        spilling += bool(st or ld)
        tensor += bool(n_ops)
        print(f"kernel: regs={regs} spill_stores={st} spill_loads={ld} "
              f"tensor_core_instructions={n_ops} {names[name]}")
    print(f"ptxas: {len(table)} kernel instantiations, {spilling} spill, "
          f"{tensor} with tensor-core instructions")
    # the MLA decode kernels: every bf16 split body on the tensor cores,
    # and no instantiation spills
    mla = [n for n in table if "mla_" in names[n]]
    tc_partial = [n for n in mla
                  if re.search(r"tc(::|\d+)mla_partial_kernel", names[n])]
    bare = [n for n in tc_partial if not ops.get(n, 0)]
    spill = [n for n in mla if table[n][1] or table[n][2]]
    print(f"mla: {len(mla)} instantiations, {len(tc_partial)} bf16 split "
          f"bodies of which {len(tc_partial) - len(bare)} with tensor-core "
          f"instructions, {len(spill)} spill")
    # the int8 decode split passes (4 G x their K x 2 query dtypes x 2
    # address policies): none may spill
    int8 = [n for n in table if "decode_int8_detail" in names[n]]
    int8_spill = [n for n in int8 if table[n][1] or table[n][2]]
    print(f"int8 decode: {len(int8)} split-pass instantiations, "
          f"{len(int8_spill)} spill")
    # the rmsnorm instantiations (4 type pairs x 7 16-byte layouts and 4
    # one-element ones): none may spill
    norm = sorted((n for n in table if "rmsnorm_kernel" in names[n]),
                  key=lambda n: names[n])
    norm_spill = [n for n in norm if table[n][1] or table[n][2]]
    for n in norm:
        regs, st, ld = table[n]
        print(f"rmsnorm: regs={regs} spill_stores={st} spill_loads={ld} "
              f"{names[n]}")
    print(f"rmsnorm: {len(norm)} instantiations, most registers "
          f"{max((table[n][0] for n in norm), default=0)}, "
          f"{len(norm_spill)} spill")
    return 1 if (bare or spill or not tc_partial or not int8
                 or int8_spill or not norm or norm_spill) else 0


if __name__ == "__main__":
    sys.exit(main())
