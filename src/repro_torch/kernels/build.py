"""Builds the CUDA kernels and keeps the count of their launches.

``extension()`` compiles every CUDA source under ``csrc/`` with ONE
``torch.utils.cpp_extension.load`` call for ``sm_90a`` into ``build/``
at the root of the checkout, on first CUDA use, and loads the result;
later calls return the loaded module. No source includes the PyTorch
headers: the ``.cu`` files are plain CUDA and ``csrc/binding.cpp`` needs
only pybind11, since the Python wrappers pass raw pointers.
"""
from __future__ import annotations

import pathlib
import threading

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("binding.cpp", "flash_attention.cu", "decode_attention.cu",
           "paged_attention.cu", "ssd_scan.cu", "mla_decode.cu")

CUDA_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a")

_lock = threading.Lock()
_ext = None  # the loaded extension, once built


def load_kernels(build_dir: pathlib.Path, extra_cuda_flags=(),
                 verbose: bool = False):
    """Compile and load every source under ``csrc/`` into ``build_dir``."""
    from torch.utils.cpp_extension import load
    build_dir.mkdir(parents=True, exist_ok=True)
    return load(name="repro_torch_kernels",
                sources=[str(_CSRC / s) for s in SOURCES],
                build_directory=str(build_dir), extra_cflags=["-O2"],
                extra_cuda_cflags=[*CUDA_FLAGS, *extra_cuda_flags],
                verbose=verbose)


def extension():
    """The compiled kernel module, built on first use (thread-safe: two
    engines reaching their first launch together build once)."""
    global _ext
    with _lock:
        if _ext is None:
            _ext = load_kernels(BUILD_DIR)
    return _ext


def check_launch(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs
    and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({extension().error_string(err)})")


class LaunchCounter:
    """Launches of one kernel: the wrapper adds one where it launches, so a
    run can show that its path went through the kernel. Thread-safe, since
    container threads launch concurrently."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._n = 0

    def add(self) -> None:
        with self._lock:
            self._n += 1

    @property
    def value(self) -> int:
        return self._n

    def reset(self) -> None:
        with self._lock:
            self._n = 0
