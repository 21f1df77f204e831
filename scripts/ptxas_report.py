#!/usr/bin/env python3
"""Registers, spills and tensor-core instructions of every compiled kernel
of the port, on a machine with ``nvcc``.

    python3 scripts/ptxas_report.py

Builds ``src/repro_torch/kernels/csrc`` with the port's own flags plus
``-Xptxas=-v`` into ``build/kernels_ptxas``, emptied first so that every
source compiles and ptxas reports every kernel (the port's
``build/kernels`` is left alone); the ptxas output goes to this
process's standard output as the build runs. Then it reads the built library's SASS with
``cuobjdump -sass`` and prints one line per kernel instantiation: its
registers, spill stores and loads (bytes, from ptxas) and its count of
tensor-core instructions (``HMMA``, or ``HGMMA`` for ``wgmma``), so a
reader can see which bodies run their products on the tensor cores. Ends
with a count of instantiations, spilling ones and ones with tensor-core
instructions, then the MLA decode kernels' and the int8 decode split
passes' own counts, and the rmsnorm instantiations' registers and spills
one by one, and the split decode body's instantiations at the pairs past
G * K <= 512, (G, K) = (1, 112) and (6, 128), one by one; it exits 1
unless every bf16 MLA split body has tensor-core instructions, no MLA
instantiation spills, the int8 split passes are there and none of them
spills, the rmsnorm instantiations are there and none of them spills,
and the 12 split decode instantiations at the new pairs (split pass: 2
query dtypes x 2 address policies x 2 pairs; merge: 2 x 2) are there
and none of them spills, and the 8 int8 split passes at those pairs (2
query dtypes x 2 address policies x 2 pairs; the merge is the split
body's) are there, listed one by one, and none of them spills. The
float32 flash bodies (the forward's split-TF32 body and the backward's
dq and dk/dv passes) are listed one by one too; it exits 1 unless every
one of them has tensor-core instructions and none that the registry's
head shapes reach (K / Kv 64 / 64, 112 / 112, 128 / 128 and 192 / 128:
tiles 64 / 64, 128 / 128 and 192 / 128) spills. The bfloat16 backward's
two wgmma kernels (flash_attention_bwd_bf16.cu: the walk over key tiles
and the dq pass, 12 tile pairs each, with and without a softcap) are
listed one by one the same way; it exits 1 unless all 48 are there, each
has wgmma (HGMMA) instructions and none of the 12 the registry reaches
spills.
The RMSNorm backward's 62 instantiations (its rows pass at 7 layouts
with 16-byte loads and one element at a time for each of the 4 pairs of
row and scale dtypes, the looping body for each pair, the dscale pass
for each scale dtype) are listed one by one; it exits 1 unless all 62
are there and none spills. The float32 SSD scan's and its backward's 8 (ssd_f32.cuh's
chunk-state and pass kernels, one copy in each of ssd_scan.cu and
ssd_scan_bwd.cu; the forward's output kernel; the backward's dx / ddt,
dB / dC and sums kernels) are listed one by one; it exits 1 unless all 8
are there, none spills, and the 5 that run products (chunk states,
outputs, dx / ddt, dB / dC) have tensor-core instructions.
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


def tensor_ops(library: pathlib.Path, op: str = r"H(G)?MMA") -> dict:
    """{mangled name: instructions matching ``op`` (HMMA + HGMMA by
    default)} from cuobjdump -sass."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name and re.search(rf"\b{op}\b", line):
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

    # a build left from an earlier run would compile nothing and print no
    # ptxas lines
    shutil.rmtree(BUILD, ignore_errors=True)
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
    # the split decode body at (G, K) = (1, 112) and (6, 128)
    new = sorted((n for n in table if re.search(
        r"decode_split_detail::decode_(split|merge)_kernel<[^,<>]+, "
        r"(1, 112|6, 128)\b", names[n])), key=lambda n: names[n])
    new_spill = [n for n in new if table[n][1] or table[n][2]]
    for n in new:
        regs, st, ld = table[n]
        print(f"split decode new shape: regs={regs} spill_stores={st} "
              f"spill_loads={ld} {names[n]}")
    print(f"split decode new shapes: {len(new)} instantiations, most "
          f"registers {max((table[n][0] for n in new), default=0)}, "
          f"{len(new_spill)} spill")
    # the int8 split pass at the same pairs
    new8 = sorted((n for n in table if re.search(
        r"decode_int8_detail::decode_int8_split_kernel<[^,<>]+, "
        r"(1, 112|6, 128)\b", names[n])), key=lambda n: names[n])
    new8_spill = [n for n in new8 if table[n][1] or table[n][2]]
    for n in new8:
        regs, st, ld = table[n]
        print(f"int8 decode new shape: regs={regs} spill_stores={st} "
              f"spill_loads={ld} {names[n]}")
    print(f"int8 decode new shapes: {len(new8)} instantiations, most "
          f"registers {max((table[n][0] for n in new8), default=0)}, "
          f"{len(new8_spill)} spill")
    # the float32 flash bodies on the tensor cores (split TF32), and the
    # tile widths the registry's head shapes reach
    f32 = sorted((n for n in table if re.search(
        r"f32tc::flash_attention_f32_kernel<|dq_kernel<|dkdv_kernel<",
        names[n])), key=lambda n: names[n])
    f32_bare = [n for n in f32 if not ops.get(n, 0)]
    reached = [n for n in f32 if re.search(r"<(64, 64|128, 128|192, 128)\b",
                                           names[n])]
    f32_spill = [n for n in reached if table[n][1] or table[n][2]]
    for n in f32:
        regs, st, ld = table[n]
        print(f"flash f32: regs={regs} spill_stores={st} spill_loads={ld} "
              f"tensor_core_instructions={ops.get(n, 0)} "
              f"registry={'yes' if n in reached else 'no'} {names[n]}")
    print(f"flash f32: {len(f32)} instantiations, {len(f32) - len(f32_bare)} "
          f"with tensor-core instructions, {len(reached)} the registry "
          f"reaches of which {len(f32_spill)} spill")
    # the bf16 backward's wgmma kernels (flash_attention_bwd_bf16.cu): the
    # walk over key tiles and the dq pass, at every tile pair and with and
    # without a softcap, each on the tensor cores as wgmma (HGMMA); those
    # the registry's heads reach may not spill
    bf16 = sorted((n for n in table if re.search(
        r"bwd_bf16_(walk|dq_pass)_kernel<", names[n])),
        key=lambda n: names[n])
    hgmma = tensor_ops(pathlib.Path(ext.__file__), "HGMMA")
    bf16_bare = [n for n in bf16 if not hgmma.get(n, 0)]
    bf16_reached = [n for n in bf16 if re.search(
        r"<(64, 64|128, 128|192, 128), (true|false)>", names[n])]
    bf16_spill = [n for n in bf16_reached if table[n][1] or table[n][2]]
    for n in bf16:
        regs, st, ld = table[n]
        print(f"flash bwd bf16: regs={regs} spill_stores={st} "
              f"spill_loads={ld} wgmma_instructions={hgmma.get(n, 0)} "
              f"registry={'yes' if n in bf16_reached else 'no'} {names[n]}")
    print(f"flash bwd bf16: {len(bf16)} instantiations, "
          f"{len(bf16) - len(bf16_bare)} with wgmma instructions, "
          f"{len(bf16_reached)} the registry reaches of which "
          f"{len(bf16_spill)} spill")
    # the norm backward: 14 rows passes (7 layouts, 16-byte and one
    # element) and the looping body for each pair of row and scale
    # dtypes, the dscale pass for each scale dtype; every width reaches
    # one, so none may spill
    nbwd = sorted((n for n in table if re.search(
        r"::(rows_kernel|wide_kernel|dscale_kernel)<", names[n])),
        key=lambda n: names[n])
    nbwd_spill = [n for n in nbwd if table[n][1] or table[n][2]]
    for n in nbwd:
        regs, st, ld = table[n]
        print(f"rmsnorm_bwd: regs={regs} spill_stores={st} spill_loads={ld} "
              f"{names[n]}")
    print(f"rmsnorm_bwd: {len(nbwd)} instantiations, most registers "
          f"{max((table[n][0] for n in nbwd), default=0)}, "
          f"{len(nbwd_spill)} spill")
    # the float32 SSD scan and its backward, split TF32 on the tensor cores
    ssd = sorted((n for n in table if re.search(
        r"ssd32::(chunk_state|state_pass)_kernel|f32::chunk_out_kernel|"
        r"ssd_(grads|dbc|reduce)_kernel", names[n])), key=lambda n: names[n])
    ssd_spill = [n for n in ssd if table[n][1] or table[n][2]]
    ssd_mma = [n for n in ssd if re.search(
        r"chunk_state_kernel|chunk_out_kernel|ssd_grads_kernel|ssd_dbc_kernel",
        names[n])]
    ssd_bare = [n for n in ssd_mma if not ops.get(n, 0)]
    for n in ssd:
        regs, st, ld = table[n]
        print(f"ssd f32: regs={regs} spill_stores={st} spill_loads={ld} "
              f"tensor_core_instructions={ops.get(n, 0)} {names[n]}")
    print(f"ssd f32: {len(ssd)} instantiations, {len(ssd_mma) - len(ssd_bare)}"
          f" of {len(ssd_mma)} product kernels with tensor-core instructions, "
          f"{len(ssd_spill)} spill")
    return 1 if (bare or spill or not tc_partial or not int8
                 or int8_spill or not norm or norm_spill or len(new) != 12
                 or new_spill or len(new8) != 8 or new8_spill or not f32
                 or f32_bare or len(reached) < 9 or f32_spill
                 or len(bf16) != 48 or bf16_bare or len(bf16_reached) != 12
                 or bf16_spill
                 or len(nbwd) != 62 or nbwd_spill or len(ssd) != 8
                 or len(ssd_mma) != 5 or ssd_bare or ssd_spill) else 0


if __name__ == "__main__":
    sys.exit(main())
