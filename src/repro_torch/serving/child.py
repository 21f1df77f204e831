"""The process container's child body — kept import-light on purpose (the
port's counterpart of ``repro.serving.child``).

``spawn_pinned`` (``core/testbed.py``) promises that the child applies its
cpuset BEFORE torch initialises, so torch's intra-op thread pool is sized
from the container's cores rather than the whole host. That promise is
only as good as the spawn payload: the spawn start method pickles the
child target *by reference* (module + qualname) and its arguments by
value, and unpickling them at child bootstrap imports their modules —
before ``_pinned_main`` runs ``sched_setaffinity``. So this module's
import closure is the standard library plus the torch-free modules whose
objects ride in the arguments (``configs.base.ArchConfig``,
``serving.faults.FaultPlan``), the engine config crosses as primitives
(``backend._engine_config_wire``), and the weights never ride in the
arguments: a CUDA tensor unpickles by importing torch. The child pins,
then imports torch, then receives the weights over the pipe.
``tests/test_torch_process.py`` checks this closure with torch blocked.

Weights. The parent sends ``("params", tree)`` right after the spawn.
``torch.multiprocessing`` (imported with torch) pickles a CUDA tensor as
a CUDA IPC handle, so every child maps the parent's one copy of the
weights instead of holding its own; a CPU tensor moves to shared memory.
The parent keeps the tree alive while any child may attach, respawns
included. With ``params_seed`` the child draws its own weights instead
(``Model.init(seed, dtype)``).
"""
from __future__ import annotations

import gc
import os
import threading
import time

_IDLE_POLL_S = 0.05


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    return tree.nbytes


def _serving_child(conn, cid: int, cfg, device: str, engine_kw: dict,
                   incarnation: int = 0, fault_plan=None,
                   heartbeat_s: float = 0.0,
                   params_seed: int | None = None) -> None:
    """Container body (module-level: spawn pickles it by reference).
    Affinity was already applied by ``spawn_pinned``; the torch import
    below therefore sizes the intra-op pool from the container's cpuset.
    ``engine_kw`` is ``_engine_config_wire`` output — one EngineConfig,
    primitives only, the dtype by name.

    Streaming protocol, as in the JAX child: ``("submit", [Request...])``
    enqueues, ``("cancel", rid)`` removes one request (queued or
    mid-decode), ``("close",)`` ends the child. Every message already in
    the pipe is taken before the next engine step, so requests that
    arrive together are admitted together. After every engine macro-step
    (and after zero-budget submissions, which complete instantly) the
    child flushes ``("events", [Event...], busy_s, tokens_generated,
    launch_counts)``; ``launch_counts`` is its ``ops.launch_counts()``, so
    the parent can show that the kernels ran in the children. A
    ``("stats", reset)`` request is answered with ``("stats",
    launch_counts, memory)`` (the counts before an optional reset). With
    ``heartbeat_s`` a daemon thread also sends ``("hb",)`` on that period,
    so the parent can tell a slow child (heartbeats flowing, no events)
    from a hung one (silence).

    The handshake is ``("ready", cores, info)``: the cpuset the child
    runs on, and ``info`` with the received weights' bytes,
    ``torch.cuda.memory_allocated()`` right after taking them (0 on the
    CPU), which shows whether the child holds a copy of its own, and
    whether torch was already imported when the pinned body began (it
    must not be).

    Exits are classified (``EXIT_*`` in ``serving/faults.py``): startup
    failures, a lost pipe and engine-step errors each get a distinct
    nonzero code, an injected kill ``os._exit``s with its own."""
    import sys
    import traceback

    # _pinned_main calls this body right after sched_setaffinity: torch in
    # sys.modules here means something imported it before the pin
    torch_preloaded = "torch" in sys.modules
    from repro_torch.serving.faults import (EXIT_FAULT_KILL, EXIT_PIPE_LOST,
                                            EXIT_STARTUP, EXIT_STEP_ERROR,
                                            FaultInjector, InjectedFault)
    send_lock = threading.Lock()

    def send(msg) -> None:
        # the heartbeat thread and the serve loop share the pipe; writes
        # interleave at message granularity only under a lock
        with send_lock:
            conn.send(msg)

    try:
        import torch

        from repro_torch.device import resolve_device
        from repro_torch.kernels import ops
        from repro_torch.models.model import Model
        from repro_torch.serving.engine import EngineConfig, ServingEngine

        dev = resolve_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            # the parent built the kernels before the first spawn: this
            # only loads them, and before "ready", so no fault can land
            # inside a build
            from repro_torch.kernels.build import extension
            extension()
        model = Model(cfg, device=dev)
        kw = dict(engine_kw)
        kw["dtype"] = getattr(torch, kw["dtype"])
        config = EngineConfig(**kw)
        if params_seed is None:
            msg = conn.recv()
            if msg[0] != "params":
                raise RuntimeError(f"expected the weights, got {msg[0]!r}")
            params = msg[1]
        else:
            params = model.init(seed=params_seed, dtype=config.dtype)
        info = {"torch_preloaded": torch_preloaded,
                "weight_bytes": _tree_bytes(params),
                "memory_allocated": (torch.cuda.memory_allocated(dev)
                                     if dev.type == "cuda" else 0)}
        engine = ServingEngine(model, params, config, device=dev)
        # events cross the pipe as-is: the child must stamp the parent's
        # container id or every child would claim container 0
        engine.container_id = cid
        inj = FaultInjector(fault_plan, cid, incarnation)
        engine.fault = inj if inj.armed else None
        buf: list = []
        engine.on_event = buf.append

        def memory() -> dict:
            if dev.type != "cuda":
                return {"memory_allocated": 0, "max_memory_allocated": 0}
            return {"memory_allocated": torch.cuda.memory_allocated(dev),
                    "max_memory_allocated":
                        torch.cuda.max_memory_allocated(dev)}
        try:
            cores = sorted(os.sched_getaffinity(0))
        except AttributeError:              # non-Linux dev host
            cores = []
        send(("ready", cores, info))
    except BaseException:
        try:
            send(("error", traceback.format_exc()))
        except Exception:
            pass
        sys.exit(EXIT_STARTUP)
    if heartbeat_s > 0:
        hb_stop = threading.Event()

        def _heartbeat() -> None:
            while not hb_stop.wait(heartbeat_s):
                try:
                    send(("hb",))
                except Exception:
                    return              # pipe gone: main loop exits too

        threading.Thread(target=_heartbeat, daemon=True,
                         name=f"hb-{cid}").start()
    while True:
        try:
            if buf:
                if inj.armed and inj.drop_reply():
                    buf.clear()         # injected reply loss
                    engine.done.clear()
                else:
                    delay = inj.reply_delay() if inj.armed else 0.0
                    if delay > 0:
                        time.sleep(delay)
                    send(("events", list(buf), engine.busy_s,
                          engine.tokens_generated, ops.launch_counts()))
                    buf.clear()
                    # DoneEvents carry the completions; nobody calls
                    # run() here, so drain the engine's done list or it
                    # grows without bound across a long-lived stream
                    engine.done.clear()
            timeout = 0 if engine.has_work else _IDLE_POLL_S
            if conn.poll(timeout):
                msg = conn.recv()
                if msg[0] == "close":
                    conn.close()
                    # free the weights while CUDA is up: freeing a tensor
                    # mapped from the parent gives back its share's
                    # reference counter, and torch keeps the parent's copy
                    # allocated until every share is given back
                    del engine, params
                    gc.collect()
                    return
                if msg[0] == "submit":
                    engine.submit_many(msg[1])
                    continue               # flush instant completions
                if msg[0] == "cancel":
                    engine.cancel(msg[1])
                    continue
                if msg[0] == "stats":
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                    send(("stats", ops.launch_counts(), memory()))
                    if msg[1]:
                        ops.reset_launch_counts()
                    continue
            if engine.has_work:
                engine.step()
        except InjectedFault as e:
            if e.fault.kind == "kill":
                os._exit(EXIT_FAULT_KILL)  # a real crash: no cleanup
            try:
                send(("error", traceback.format_exc()))
            except Exception:
                pass
            sys.exit(EXIT_STEP_ERROR)
        except (EOFError, BrokenPipeError):  # parent died / closed
            sys.exit(EXIT_PIPE_LOST)
        except SystemExit:
            raise
        except BaseException:
            # engine state after an arbitrary step error is not
            # trustworthy — report and exit so the parent respawns a
            # clean incarnation
            try:
                send(("error", traceback.format_exc()))
            except (BrokenPipeError, OSError):
                sys.exit(EXIT_PIPE_LOST)
            sys.exit(EXIT_STEP_ERROR)
