"""The paper's experiment on the PyTorch/CUDA port: video object detection
split among pinned containers (``repro_torch.core.testbed``).

A synthetic video (independent frames) is processed by a YOLOv4-tiny-shaped
detector. The workload is split into n equal segments; n OS processes
("containers") are pinned to disjoint CPU-core sets (the in-process
equivalent of ``docker run --cpus``) and run at once; outputs are
recombined in frame order. With ``--device cuda`` (the default) the n
containers share the one card, as the paper's share one Jetson; with
``--device cpu`` they run on their cores alone. Real wall times; energy
from the activity model (constants in ``core/testbed.py``; no sensor is
read).

Finally the DivideAndSave scheduler consumes the observations and picks the
optimal container count (paper §VII's proposed application).

``--stream`` serves the paper's *continuous* form of the same workload
through the request-level ``Router``: the video becomes a stream of
per-frame requests (``VideoRequestStream``) admitted one at a time, and
the scheduler resizes the container count between observation windows.
It serves full-width qwen3-0.6b (bf16, random weights from a seed) on the
card and qwen3-0.6b-reduced with ``--device cpu``.

    PYTHONPATH=src python examples/torch_serve_video_detection.py \\
        --frames 240 --cores 8
    PYTHONPATH=src python examples/torch_serve_video_detection.py \\
        --device cpu --frames 16 --cores 2 --counts 1 2
    PYTHONPATH=src python examples/torch_serve_video_detection.py \\
        --stream --frames 48 --window 12

The module scope imports no torch: the spawned containers import this
script before they pin themselves.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import testbed
from repro_torch.core.energy_model import fit_best
from repro_torch.core.scheduler import DivideAndSaveScheduler


def stream_main(args) -> None:
    """The continuous-workload mode: per-frame requests through the
    Router, windowed online scheduling instead of waves."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import VideoRequestStream
    from repro_torch.models.model import Model
    from repro_torch.serving.backend import ThreadBackend
    from repro_torch.serving.engine import EngineConfig, Request
    from repro_torch.serving.router import Router

    cpu = args.device == "cpu"
    cfg = get_config("qwen3-0.6b-reduced" if cpu else "qwen3-0.6b")
    dtype = torch.float32 if cpu else torch.bfloat16
    model = Model(cfg, device=args.device)
    params = model.init(seed=0, dtype=dtype)
    config = EngineConfig(n_slots=2, max_len=64, dtype=dtype)
    stream = VideoRequestStream(n_frames=args.frames, seed=0)
    prompts = stream.prompt_requests(cfg.vocab_size, prompt_len=8)
    print(f"video stream: {args.frames} frame-requests to {cfg.name} on "
          f"{args.device}, window {args.window}, feasible counts "
          f"{args.counts}\n")

    router = Router(
        backend_factory=lambda n: ThreadBackend(
            model, params, n, config, device=args.device),
        feasible_counts=list(args.counts),
        objective="energy", window=args.window, device=args.device)
    handles = []
    for rid, prompt in enumerate(prompts):
        handles.append(router.submit(Request(rid=rid, prompt=prompt,
                                             max_new_tokens=4)))
        router.poll()               # frames keep arriving mid-decode
        if (rid + 1) % args.window == 0:
            # arrival pause (the camera's next GOP): the stream drains,
            # which is when a pending resize takes effect
            router.drain()
    router.drain()
    if not all(h.done for h in handles):
        raise RuntimeError("the stream ended with requests still open")
    for w in router.history:
        print(f"window {w.window}: n={w.n_containers} wall {w.wall_s:.2f}s"
              f" {w.tokens_per_s:.1f} tok/s energy {w.energy_j:.1f}J "
              f"ttfc p50 {w.ttfc_p50_s * 1e3:.0f}ms "
              f"p95 {w.ttfc_p95_s * 1e3:.0f}ms")
    print(f"\n{len(handles)} frames served in submission order: "
          f"{[h.rid for h in handles] == list(range(args.frames))}")
    print(f"scheduler's converged choice: n={router.choice}")
    router.close()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=240)
    ap.add_argument("--cores", type=int, default=8)
    ap.add_argument("--counts", type=int, nargs="*",
                    default=[1, 2, 3, 4, 6, 8])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the card (default) or the plain CPU path")
    ap.add_argument("--stream", action="store_true",
                    help="continuous per-frame requests through the "
                         "Router (windowed online scheduling)")
    ap.add_argument("--window", type=int, default=16,
                    help="scheduler observation window (requests)")
    args = ap.parse_args()
    if args.stream:
        stream_main(args)
        return

    frames = testbed.make_video(args.frames)
    print(f"video: {args.frames} frames {frames.shape[1:]}  host: "
          f"{args.cores} cores  device: {args.device}\n")
    base = None
    observations = []
    print("  n  cores/ctr   wall (s)   power (W)   energy (J)   "
          "t/t1    E/E1   outputs")
    for n in args.counts:
        # allow_shared: counts past this host's core budget fall back to
        # explicit round-robin time-sharing (run_split refuses a silent
        # overlap) so the paper-style sweep works on small hosts
        r = testbed.run_split(frames, n, total_cores=args.cores,
                              batch=args.batch, allow_shared=True,
                              device=args.device)
        if base is None:
            base = r
        ok = "✓" if np.allclose(r.outputs, base.outputs, atol=1e-5) else "✗"
        observations.append((n, r.wall_s, r.energy_j))
        print(f"  {n:2d}  {r.cores_per_container:9d}   {r.wall_s:8.2f}   "
              f"{r.avg_power_w:9.1f}   {r.energy_j:10.1f}   "
              f"{r.wall_s/base.wall_s:5.2f}  {r.energy_j/base.energy_j:5.2f}"
              f"   {ok}")

    ns = np.array([o[0] for o in observations], float)
    tfit = fit_best(ns, np.array([o[1] for o in observations]) / base.wall_s)
    efit = fit_best(ns, np.array([o[2] for o in observations])
                    / base.energy_j)
    print(f"\nfitted time model:   {tfit.kind} "
          f"{tuple(round(c, 3) for c in tfit.coef)} (rmse {tfit.rmse:.3f})")
    print(f"fitted energy model: {efit.kind} "
          f"{tuple(round(c, 3) for c in efit.coef)} (rmse {efit.rmse:.3f})")

    sched = DivideAndSaveScheduler(list(args.counts), objective="energy",
                                   epsilon=0.0)
    for n, t, e in observations:
        sched.observe(n, t, e)
    print(f"scheduler picks n* = {sched.pick()} (energy objective)")

    n_best, t_best, e_best = min(observations, key=lambda o: o[2])
    print(f"\nbest measured: n={n_best}: "
          f"time −{(1-t_best/base.wall_s)*100:.0f}%  "
          f"energy −{(1-e_best/base.energy_j)*100:.0f}% vs one container")


if __name__ == "__main__":
    main()
