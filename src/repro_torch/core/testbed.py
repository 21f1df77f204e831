"""The paper's containers on this host: the pinned-process harness and
the video-detection testbed of §V (the port's copy of
``repro.core.testbed``).

``docker run --cpus=C/n`` becomes an OS process pinned to a disjoint set
of C/n cores with ``os.sched_setaffinity``, applied BEFORE the child
imports torch: torch sizes its intra-op thread pool from the process's
cpuset at first import, as XLA does, so the affinity has to come first.
``assign_core_sets`` carves the host's cores into one set per container
(pairwise disjoint, by construction and by assertion), ``spawn_pinned``
starts ``body(conn, *args)`` in a fresh ``spawn`` process that pins
itself in ``_pinned_main`` before it runs the body.

On that harness ``run_split`` runs the paper's experiment: a video of
independent frames, split into n equal segments, goes through a
YOLOv4-tiny-shaped detector in n pinned containers at once, and the
outputs are combined in frame order. With ``device="cuda"`` (the
default) the n containers share the one card, as the paper's n
containers share one Jetson; ``device="cpu"`` runs them on their cores
alone. Energy is the activity model of the reference, ``P(t) = P_IDLE +
P_CORE * busy_cores(t)``, with its constants: no sensor is read here.

This module imports no torch and no numpy: spawn pickles
``_pinned_main`` by reference, so the child imports this module at
bootstrap, before any affinity is applied. The detector's functions
import them inside themselves, the body after the pin.
"""
from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import time
import traceback
from typing import TYPE_CHECKING, Callable, Sequence

from repro_torch.serving.faults import describe_exitcode

if TYPE_CHECKING:
    import numpy as np

P_IDLE_W = 40.0    # host idle draw
P_CORE_W = 3.5     # per busy core

_FRAME_SHAPE = (128, 128, 3)
# YOLOv4-tiny-ish backbone: stride-2 conv stages + 1x1 head (CSP blocks
# collapsed — the compute/memory character, not mAP)
_CHANNELS = (16, 32, 64, 128, 256)
_HEAD = 18
_POLL_S = 0.05


def available_cores() -> list[int]:
    """Cores this process may use — ``sched_getaffinity`` where it exists
    (Linux: respects cgroup/container cpusets), ``cpu_count`` elsewhere so
    non-Linux dev hosts still get a sane carve-up (children then run
    unpinned, see ``_pinned_main``)."""
    try:
        return sorted(os.sched_getaffinity(0))
    except AttributeError:
        return list(range(os.cpu_count() or 1))


def assign_core_sets(n_containers: int, total_cores: int | None = None,
                     avail: Sequence[int] | None = None,
                     allow_shared: bool = False) -> list[frozenset[int]]:
    """Carve the host's cores into one set per container — the
    ``docker run --cpus`` allocation as explicit cpusets.

    With ``n_containers <= cores`` the sets are contiguous, equal-size
    (``cores // n``) and pairwise disjoint; disjointness is asserted, not
    assumed, because it IS the isolation claim every measurement rests on.
    With more containers than cores the request is contradictory unless
    ``allow_shared=True``, which degrades to round-robin single-core sets
    (kernel time-slicing — the fractional-share analogue).
    """
    if n_containers <= 0:
        raise ValueError("n_containers must be positive")
    if avail is None:
        avail = available_cores()
    else:
        avail = sorted(set(avail))
    if total_cores is not None:
        if total_cores <= 0:
            raise ValueError("total_cores must be positive")
        avail = avail[:total_cores]
    total = len(avail)
    if n_containers > total:
        if not allow_shared:
            raise ValueError(
                f"{n_containers} containers over {total} cores cannot have "
                "pairwise-disjoint core sets; reduce n_containers or pass "
                "allow_shared=True to accept round-robin time-shared cores "
                "(the --cpus < 1 fractional-share analogue)")
        return [frozenset({avail[i % total]}) for i in range(n_containers)]
    cpc = total // n_containers
    sets = [frozenset(avail[i * cpc:(i + 1) * cpc])
            for i in range(n_containers)]
    seen: set[int] = set()
    for s in sets:
        if len(s) != cpc or seen & s:
            raise AssertionError(
                "core assignment produced overlapping or ragged sets")
        seen |= s
    return sets


def _pinned_main(cores: Sequence[int], body: Callable, conn, args) -> None:
    """Child entry point: affinity FIRST, then the body (whose torch import
    sizes the intra-op pool from the already-restricted cpuset)."""
    try:
        os.sched_setaffinity(0, set(cores))
    except (AttributeError, OSError):   # non-Linux dev hosts: run unpinned
        pass
    body(conn, *args)


def spawn_pinned(body: Callable, cores: Sequence[int], args: tuple = (),
                 ctx=None):
    """Spawn ``body(conn, *args)`` in a fresh process pinned to ``cores``
    before torch can initialise. Returns ``(process, parent_conn)``.

    ``body`` must be a module-level (picklable) function in a module that
    imports no torch, and must do its torch import inside itself; ``args``
    must unpickle without torch too (send tensors over the pipe after the
    child has pinned itself). The spawn start method is the only one: a
    forked child cannot use CUDA.
    """
    ctx = ctx or mp.get_context("spawn")
    if ctx.get_start_method() != "spawn":
        raise ValueError("spawn_pinned needs the spawn start method (a "
                         "forked child cannot use CUDA)")
    parent, child = ctx.Pipe()
    proc = ctx.Process(target=_pinned_main,
                       args=(sorted(cores), body, child, args))
    proc.start()
    child.close()
    return proc, parent


# ---------------------------------------------------------------------------
# the paper's video-detection workload on that harness
# ---------------------------------------------------------------------------
def detector_weights(seed: int = 0) -> list[np.ndarray]:
    """The detector's weights as float32 numpy arrays in PyTorch's OIHW
    layout: five 3x3 convolutions (3 -> 16 -> ... -> 256 channels), then
    the 1x1 head of 18, each 0.1 x N(0, 1) from
    ``np.random.default_rng(seed)``. These are not the reference's
    weights, which its child draws from ``jax.random.PRNGKey(0)``; convert
    those with ``weights_from_jax``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    shapes, cin = [], _FRAME_SHAPE[-1]
    for cout in _CHANNELS:
        shapes.append((cout, cin, 3, 3))
        cin = cout
    shapes.append((_HEAD, cin, 1, 1))
    return [(0.1 * rng.standard_normal(s)).astype(np.float32)
            for s in shapes]


def weights_from_jax(convs: Sequence, head) -> list[np.ndarray]:
    """The reference's detector weights (HWIO arrays: the five
    convolutions, then the head) as this module's list (OIHW float32)."""
    import numpy as np

    return [np.ascontiguousarray(np.asarray(w, np.float32).transpose(
        3, 2, 0, 1)) for w in (*convs, head)]


def _same_pad(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's ``"SAME"`` padding of one axis, (before, after): the larger
    half after, so a stride-2 3x3 window over an even size pads 0, 1."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def detector_forward(weights, x):
    """The detector on a batch of NHWC float32 frames (a torch tensor on
    the weights' device): five stride-2 3x3 convolutions with ``"SAME"``
    padding, each followed by a leaky relu of 0.1, the 1x1 head, and the
    max over H and W. Returns (B, 18) float32."""
    import torch.nn.functional as F

    x = x.permute(0, 3, 1, 2)
    for w in weights[:-1]:
        top, bottom = _same_pad(x.shape[2], w.shape[2], 2)
        left, right = _same_pad(x.shape[3], w.shape[3], 2)
        x = F.conv2d(F.pad(x, (left, right, top, bottom)), w, stride=2)
        x = x.maximum(0.1 * x)
    x = F.conv2d(x, weights[-1])
    return x.amax(dim=(2, 3))


def _batches(frames: np.ndarray, batch: int):
    """``frames`` in batches of ``batch``, the tail padded with zero frames
    so that every call has one shape (an empty segment gives one batch of
    zeros, for the warm-up)."""
    import numpy as np

    for i in range(0, max(len(frames), 1), batch):
        fb = frames[i:i + batch]
        if len(fb) < batch:
            fb = np.concatenate([fb, np.zeros((batch - len(fb),
                                               *frames.shape[1:]),
                                              np.float32)])
        yield fb


def _detector_body(conn, go, frames, batch, weights, device):
    """Container body. Affinity was set by the harness; torch is imported
    here (its intra-op pool follows the cpuset), TF32 is turned off for
    this process, then one warm-up batch, "ready", and on ``go`` the timed
    loop: each batch to the device, through the detector, and back. Any
    failure goes back as ("error", traceback) instead of a result."""
    try:
        import numpy as np
        import torch

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = torch.device(device)
        ws = [torch.from_numpy(w).to(dev) for w in weights]
        with torch.inference_mode():
            warm = next(_batches(frames[:batch], batch))
            detector_forward(ws, torch.from_numpy(warm).to(dev)).cpu()
        conn.send(("ready",))
        go.wait()
        t0 = time.perf_counter()
        outs = []
        with torch.inference_mode():
            for fb in _batches(frames, batch):
                outs.append(detector_forward(
                    ws, torch.from_numpy(fb).to(dev)).cpu().numpy())
        dt = time.perf_counter() - t0
        conn.send(("done", dt, np.concatenate(outs)[:len(frames)]))
    except BaseException:
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


@dataclasses.dataclass
class SplitRunResult:
    n_containers: int
    cores_per_container: int
    wall_s: float                 # max over containers (parallel)
    per_container_s: list
    outputs: np.ndarray           # combined, original frame order
    busy_core_seconds: float
    disjoint: bool = True         # False only under allow_shared overflow

    @property
    def avg_power_w(self) -> float:
        return P_IDLE_W + P_CORE_W * self.busy_core_seconds / self.wall_s

    @property
    def energy_j(self) -> float:
        return self.avg_power_w * self.wall_s


def _expect(cid: int, proc, conn, what: str, timeout_s: float):
    """Container ``cid``'s next message, which must be ``what``; raises,
    naming the container, when it reports an error, dies or stays silent
    past ``timeout_s``."""
    deadline = time.perf_counter() + timeout_s
    while not conn.poll(_POLL_S):
        if not proc.is_alive():
            raise RuntimeError(
                f"container {cid} died ({describe_exitcode(proc.exitcode)})"
                f" before sending {what!r}")
        if time.perf_counter() > deadline:
            raise TimeoutError(f"container {cid}: no {what!r} within "
                               f"{timeout_s} s")
    msg = conn.recv()
    if msg[0] != what:
        raise RuntimeError(f"container {cid} failed:\n{msg[1]}")
    return msg[1:]


def run_split(frames: np.ndarray, n_containers: int,
              total_cores: int | None = None, batch: int = 8,
              allow_shared: bool = False, *, device: str = "cuda",
              weights: Sequence[np.ndarray] | None = None,
              timeout_s: float = 600.0) -> SplitRunResult:
    """§V: split the video into n segments, spawn n pinned containers,
    run them at once, combine their outputs in frame order. Raises for
    ``n_containers`` beyond the core budget unless ``allow_shared`` (see
    ``assign_core_sets``), before anything is spawned; raises on a host
    without a card unless ``device="cpu"``. ``weights`` defaults to
    ``detector_weights(0)``. A container that fails, dies or stays silent
    past ``timeout_s`` (at start, then again over the run) makes this
    raise, naming it; no child outlives the call."""
    from repro_torch.core import splitter

    core_sets = assign_core_sets(n_containers, total_cores=total_cores,
                                 allow_shared=allow_shared)
    if device != "cpu":
        from repro_torch.device import resolve_device
        device = str(resolve_device(device))
    if weights is None:
        weights = detector_weights(0)
    cpc = len(core_sets[0])
    disjoint = sum(len(s) for s in core_sets) == len(set().union(*core_sets))
    segs = splitter.split_array(frames, n_containers)

    ctx = mp.get_context("spawn")
    go = ctx.Event()
    procs, conns = [], []
    try:
        for cores, seg in zip(core_sets, segs):
            proc, conn = spawn_pinned(
                _detector_body, cores,
                args=(go, seg, batch, list(weights), device), ctx=ctx)
            procs.append(proc)
            conns.append(conn)
        for cid, (proc, conn) in enumerate(zip(procs, conns)):
            _expect(cid, proc, conn, "ready", timeout_s)
        t0 = time.perf_counter()
        go.set()
        times, outs = [], []
        for cid, (proc, conn) in enumerate(zip(procs, conns)):
            dt, out = _expect(cid, proc, conn, "done", timeout_s)
            times.append(dt)
            outs.append(out)
        wall = time.perf_counter() - t0
        for proc in procs:
            proc.join(timeout=timeout_s)
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=5)
            if proc.is_alive():
                proc.kill()
                proc.join()
        for conn in conns:
            conn.close()
    combined = splitter.combine_arrays(outs)
    # per-container core-seconds; under allow_shared overflow the sets
    # time-slice, so cap at what the distinct cores could physically run
    busy = sum(t * cpc for t in times)
    busy = min(busy, len(set().union(*core_sets)) * wall)
    return SplitRunResult(n_containers, cpc, wall, times, combined, busy,
                          disjoint)


def run_single_container(frames: np.ndarray, cores: int, batch: int = 8, *,
                         device: str = "cuda") -> float:
    """Fig. 1 point: ONE container limited to ``cores`` cores; its wall
    seconds."""
    return run_split(frames, 1, total_cores=cores, batch=batch,
                     device=device).wall_s


def make_video(n_frames: int, seed: int = 0) -> np.ndarray:
    """``n_frames`` N(0, 1) frames (128, 128, 3) float32: the reference's
    frames for the same seed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return rng.standard_normal((n_frames, *_FRAME_SHAPE)).astype(np.float32)
