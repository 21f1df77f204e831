"""Builds the CUDA kernels and keeps the count of their launches.

``extension()`` compiles every CUDA source under ``csrc/`` with ONE
``torch.utils.cpp_extension.load`` call for ``sm_90a`` into ``build/``
at the root of the checkout, on first CUDA use, and loads the result;
later calls return the loaded module. No source includes the PyTorch
headers: the ``.cu`` files are plain CUDA and ``csrc/binding.cpp`` needs
only pybind11, since the Python wrappers pass raw pointers.
"""
from __future__ import annotations

import contextlib
import pathlib
import threading

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("binding.cpp", "flash_attention.cu", "flash_attention_bwd.cu",
           "decode_attention.cu", "paged_attention.cu", "ssd_scan.cu",
           "ssd_scan_bwd.cu", "mla_decode.cu", "rmsnorm.cu", "rmsnorm_bwd.cu")

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


# the launch tally of the CUDA graph capture this thread runs, if any
_capturing = threading.local()


class LaunchCounter:
    """Launches of one kernel: the wrapper adds one where it launches, so a
    run can show that its path went through the kernel. Thread-safe, since
    container threads launch concurrently.

    A CUDA graph capture launches nothing: inside ``capture_tally`` this
    thread's adds go to the capture's tally instead, and each replay of the
    graph adds the tally (``add_launches``). Another thread's launches
    meanwhile still reach the count."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._n = 0

    def add(self, n: int = 1) -> None:
        tally = getattr(_capturing, "tally", None)
        if tally is not None:
            tally[self] = tally.get(self, 0) + n
            return
        with self._lock:
            self._n += n

    @property
    def value(self) -> int:
        return self._n

    def reset(self) -> None:
        with self._lock:
            self._n = 0


@contextlib.contextmanager
def capture_tally():
    """While open, this thread's launches are tallied into the yielded
    dict (counter -> launches), not counted: the calls made while a CUDA
    graph is captured, whose kernels run only when it is replayed."""
    outer = getattr(_capturing, "tally", None)
    _capturing.tally = tally = {}
    try:
        yield tally
    finally:
        _capturing.tally = outer


def add_launches(tally: dict, times: int = 1) -> None:
    """Count a captured tally's launches ``times`` times: once a replay."""
    for counter, n in tally.items():
        counter.add(n * times)
