#!/usr/bin/env python3
"""Registers, shared memory and spills of every compiled kernel of the
port, as ``ptxas -v`` reports them, on a machine with ``nvcc``.

    python3 scripts/ptxas_report.py

Builds ``src/repro_torch/kernels/csrc`` with the port's own flags plus
``-Xptxas=-v`` into ``build/kernels_ptxas`` (the port's ``build/kernels``
is left alone), then prints one line per kernel instantiation that
spills, and a count of instantiations and spilling ones. The ptxas
output itself goes to this process's standard output as the build runs.
"""
from __future__ import annotations

import contextlib
import io
import os
import pathlib
import re
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.build import load_kernels

    # ninja writes the compiler's output to file descriptor 1
    with tempfile.TemporaryFile(mode="w+") as log:
        saved = os.dup(1)
        os.dup2(log.fileno(), 1)
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                load_kernels(ROOT / "build" / "kernels_ptxas",
                             extra_cuda_flags=("-Xptxas=-v",), verbose=True)
        finally:
            os.dup2(saved, 1)
            os.close(saved)
            log.seek(0)
            text = log.read()
            print(text, flush=True)
    name, n_kernels, spilling = None, 0, []
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            n_kernels += 1
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name and (int(m.group(1)) or int(m.group(2))):
            spilling.append((name, int(m.group(1)), int(m.group(2))))
    for name, st, ld in spilling:
        print(f"spill: {name}: {st} bytes stores, {ld} bytes loads")
    print(f"ptxas: {n_kernels} kernel instantiations, {len(spilling)} "
          "spill")
    return 0


if __name__ == "__main__":
    sys.exit(main())
