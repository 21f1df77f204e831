"""Continuous-batching serving engine with fused multi-token decode.

A port of ``repro.serving.engine.ServingEngine`` for the dense (text
only or behind a vision prefix), gemma and MoE families (GQA or MLA),
over the dense or the paged cache (whose sliding-window rings stay dense
rows beside the paged groups), for the SSM and hybrid families over
their dense state rows (zamba's shared-block applications paged beside
them), under either cache's admission (paged: the block budget bounds
the resident sequences, the rows stay dense), and for whisper (its self
attention paged or dense, its encoder memory dense rows a sequence). A
vision model's request carries its patch embeddings as
``extras["vision_embeds"]``: the image takes the first
``n_vision_tokens`` positions of its sequence, in the cache, the block
budget and the block hashes, as in JAX. A whisper request carries its
frames as ``extras["audio_frames"]`` ((encoder_seq, d_model) float32),
which its prefill encodes and which take no position. Each ``step()``
expires deadlines,
admits queued requests and then runs one fused decode chunk (or, with
``chunked=False``, one decode step):

* **Dense admission** pops the queue head plus every queued request with
  the same admit key, up to the free slots, and prefills them as one
  batch in one call (``batch_admit=False``: one request a prefill);
  per-row ``logits_at`` picks each prompt's last real position. The key
  is the prompt-length bucket (``PROMPT_BUCKETS``), into which the batch
  is right-padded, or, for an SSM model, the exact prompt length: its
  recurrent state would absorb pad tokens (``_pad_ok``), so its batches
  are exactly as wide as their prompts; and the names of the request's
  ``extras``. The prefill rows are copied into their slots, and the
  prefill sample is each request's first streamed chunk.
* **Paged admission** (``EngineConfig(cache="paged")``) is strict FIFO on
  the block budget: the run of consecutive queue heads that share an
  admit key prefills as one batch (``batch_admit=False``: a run of one),
  each reserving ``ceil(tokens / block_size)`` blocks, and a head that
  does not fit stops admission. With ``prefix_cache`` a request's
  leading full prompt blocks map onto cached pages (chained blake2b
  block hashes over its extras and tokens) and only the residual suffix
  is prefilled, behind the gathered prefix.
* **Decode** runs one fused chunk for every active slot in lockstep. The
  chunk length is ``EngineConfig.chunk_tokens`` (None, the default: the
  H100 cost model's, ``core/roofline.engine_chunk_tokens``, at the
  engine's rows and, paged, its horizon), clamped by the shortest
  remaining budget and ``max_len`` headroom among active slots and
  rounded down to a power of two, so no step is wasted on a finished
  slot. The chunk's tokens and emitted counts come to the host in
  exactly ONE device-to-host transfer. ``chunked=False`` is the
  per-token baseline: one ``Model.decode_step``, one pick and one host
  read per generated token, always eager.
* **Picks** are the argmax, or with ``greedy=False`` a Gumbel-max sample
  over the full vocabulary (``models/sampling.py``) from the engine's one
  random stream, seeded by ``EngineConfig.seed`` and advanced once per
  pick: the prefill sample, then every decode step, in that order, as
  JAX threads its key. A chunked engine and a ``chunked=False`` one with
  the same seed therefore give the same sampled streams.
* **Deadlines**: a request's ``deadline_s`` is re-stamped on the engine's
  clock at ``submit``; each step first fails every expired request with
  ``FailedEvent(kind="deadline")``, queued ones leaving the queue and
  active ones freeing their slot (paged: through the deferred free, as
  ``cancel`` does).

Events (``serving/events.py``) are emitted as the JAX engine emits them:
one ``ChunkEvent`` per request per macro-step (per token on the
per-token path), a ``DoneEvent`` per completion and a ``FailedEvent`` per
expiry, built from data already on the host.

On the CPU a chunk is ``Model.decode_chunk``. On a CUDA device it is the
counterpart of JAX's jitted, cache-donated chunk: the engine owns its
chunk state on the card (``Model.chunk_buffers``), writes the host's
slot state and the random stream's state into it in ONE host-to-device
copy (from a pinned buffer, so the copy does not wait on the stream),
and replays a CUDA graph of one chunk step
(``Model.decode_chunk_step``) ``n_tokens`` times, as XLA loops the scan
body, before the one device-to-host copy. The graph is captured on the
engine's first chunk, after that chunk's first step ran eagerly, and
holds the cache leaves, the shared block table, the weights and the
chunk state by address: all are updated in place only, and a moved one
raises before the next replay. ``greedy`` is fixed per engine, so a
sampling engine also captures one graph; its step reads the stream's
state from the chunk buffers and advances it there, so every replay
draws new noise. ``graph_capture_s``, ``graph_pool_bytes`` (the rise of
``torch.cuda.memory_reserved()`` across the capture: the graph's private
pool) and ``graph_replays`` report it; the kernel launch counts add the
captured step's launches at each replay. ``host_reads`` counts the
device-to-host reads of picks and chunks.

Each engine issues its work on its own CUDA stream, so the kernels of a
``ThreadBackend``'s engines may overlap on one card — the GPU form of
splitting one device's work across containers. Their host work (prefill
and the chunk's bookkeeping) still shares the interpreter lock.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import threading
import time
import warnings
from collections import deque
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.roofline import engine_chunk_tokens
from repro_torch.device import resolve_device
from repro_torch.kernels.build import add_launches, capture_tally
from repro_torch.models.cache import PagedLayout
from repro_torch.models.sampling import gumbel_argmax, new_key
from repro_torch.serving.cache import DenseCache, PagedCache
from repro_torch.serving.events import ChunkEvent, DoneEvent, FailedEvent


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (prompt_len,) int32
    max_new_tokens: int
    # per-request model inputs beside the prompt, keyed by name: their
    # names enter the admit key and their bytes the block hashes, as in
    # JAX; a vision model reads "vision_embeds" ((n_vision_tokens,
    # vision_embed_dim) float32), whisper "audio_frames" ((encoder_seq,
    # d_model) float32), the text families none of them
    extras: dict = dataclasses.field(default_factory=dict)
    # seconds the request may spend in the serving stack (None = no
    # deadline): the Router stamps its own clock at submit, the engine
    # re-stamps on arrival, so the engine's expiry frees resources and
    # the Router's backstop is the end-to-end check
    deadline_s: float | None = None
    # SLO class name and tenant id, carried for the Router; the engine
    # ignores both
    priority: str = "default"
    tenant: str = ""


@dataclasses.dataclass
class Completion:
    rid: int
    tokens: list
    prompt_len: int
    latency_s: float = 0.0
    # prompt positions satisfied by prefix-cache hits (0 without sharing)
    prefix_hit_tokens: int = 0


# the request extras that are Model.prefill inputs, stacked a batch
MODEL_INPUTS = ("vision_embeds", "audio_frames")

# THE prompt-length bucket table: the engine's padded batch admission and
# the router's bucket-aware dispatch must agree on it
PROMPT_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048)


# CUDA graph captures run one at a time in the process: on entry
# torch.cuda.graph synchronizes the device and empties the allocator's
# cache, which must not meet another thread's capture in flight. Other
# threads' eager work may run during a capture ("thread_local" mode).
_CAPTURE_LOCK = threading.Lock()


def _tensors(tree, path: str = ""):
    """(path, tensor) for every tensor of a nested dict/list tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tensors(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tensors(v, f"{path}/{i}")
    elif isinstance(tree, torch.Tensor):
        yield path, tree


def _bucket(n: int, buckets=PROMPT_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    # past the table: the next power of two
    return 1 << (n - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Configuration of one ServingEngine; decode chunks of up to
    ``chunk_tokens`` steps (None: the cost model's length,
    ``core/roofline.engine_chunk_tokens``), caches in ``dtype``.

    ``greedy=False`` samples (Gumbel-max over the full vocabulary) from
    one random stream seeded by ``seed``; ``batch_admit=False`` admits one
    request a prefill; ``chunked=False`` decodes one eager step a token
    (the per-token baseline).

    ``cache="dense"``: ``n_slots`` private ``(max_len, ...)`` cache rows.
    ``cache="paged"``: a pool of ``max_blocks`` shared pages of
    ``block_size`` tokens, per-sequence block tables and up to
    ``max_seqs`` resident sequences, so in-flight concurrency is bounded
    by the block budget, not ``n_slots``. Defaults keep ``max_blocks`` at
    the dense footprint (``n_slots × max_len / block_size``) and
    ``max_seqs`` at ``max_blocks``, as in JAX. ``prefix_cache`` (paged
    only) shares full prompt blocks between requests by content hash."""
    n_slots: int = 4
    max_len: int = 512
    cache: str = "dense"
    block_size: int = 16
    max_blocks: int | None = None
    max_seqs: int | None = None
    prefix_cache: bool = False
    dtype: torch.dtype = torch.float32
    greedy: bool = True
    seed: int = 0
    batch_admit: bool = True
    chunked: bool = True
    chunk_tokens: int | None = None

    def __post_init__(self):
        if (self.n_slots < 1 or self.max_len < 2
                or (self.chunk_tokens is not None and self.chunk_tokens < 1)):
            raise ValueError(f"invalid EngineConfig {self}")
        if self.cache not in ("dense", "paged"):
            raise ValueError(f"cache must be 'dense' or 'paged', "
                             f"got {self.cache!r}")
        if self.cache == "paged" and self.max_len % self.block_size:
            raise ValueError(
                f"max_len={self.max_len} must be a multiple of "
                f"block_size={self.block_size} (a sequence's logical "
                "blocks must tile the horizon exactly)")
        if self.prefix_cache and self.cache != "paged":
            raise ValueError("prefix_cache requires cache='paged' (hits "
                             "are shared physical pages)")

    @property
    def resolved_max_blocks(self) -> int:
        if self.max_blocks is not None:
            return self.max_blocks
        return max(1, self.n_slots * self.max_len // self.block_size)

    @property
    def resolved_max_seqs(self) -> int:
        return (self.max_seqs if self.max_seqs is not None
                else self.resolved_max_blocks)

    @property
    def n_rows(self) -> int:
        """Resident-sequence capacity = batch dim of the engine cache."""
        return (self.resolved_max_seqs if self.cache == "paged"
                else self.n_slots)


@dataclasses.dataclass
class _Slot:
    active: bool = False
    rid: int = -1
    pos: int = 0                  # next position to write
    prompt_len: int = 0
    remaining: int = 0
    generated: list = dataclasses.field(default_factory=list)
    started: float = 0.0          # perf_counter stamp
    deadline: float | None = None  # absolute perf_counter expiry stamp
    hit_tokens: int = 0           # prefix-cache hit positions


class ServingEngine:
    # streaming hook: a backend sets ``on_event`` to receive the events and
    # ``container_id`` to stamp them. ``fault`` is the test-only
    # FaultInjector hook (serving/faults.py), consulted at the top of every
    # step and at each paged block allocation; None disarms it.
    on_event: Callable[[Any], None] | None = None
    container_id: int = 0
    fault: Any = None

    def __init__(self, model, params: dict,
                 config: EngineConfig | None = None, *,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine "
                             f"asked for {self.device}")
        table = params["embed"]["table"]
        if table.device != self.device:
            raise ValueError(f"params live on {table.device}, engine "
                             f"asked for {self.device}")
        self.config = config = config or EngineConfig()
        self.model = model
        self.params = params
        self.n_slots = config.n_slots
        self.max_len = config.max_len
        self.chunk_tokens = engine_chunk_tokens(model.cfg, config)
        self.paged = config.cache == "paged"
        self.layout = (PagedLayout(config.block_size,
                                   config.resolved_max_blocks)
                       if self.paged else None)
        # prefix sharing: the suffix prefill is exact only for
        # full-horizon rope GQA over all-paged groups; SSM state, sliding
        # windows, MLA latents, int8 pages and learned positions fall
        # back to the plain paged path (hit tokens stay 0, outputs
        # identical), as in JAX
        cfg = model.cfg
        self._share = (self.paged and config.prefix_cache
                       and model.fam in ("dense", "moe")
                       and not cfg.mla
                       and cfg.sliding_window == 0
                       and cfg.kv_cache_dtype != "int8"
                       and cfg.pos_embed == "rope")
        n_rows = config.n_rows
        self.stream = None
        if self.device.type == "cuda":
            self.stream = torch.cuda.Stream(self.device)
            # params were written on the caller's stream
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with self._on_stream():
            tree = model.init_cache(n_rows, config.max_len, config.dtype,
                                    layout=self.layout)
        if self.paged:
            self.cache_backend = PagedCache(tree, n_rows, self.layout,
                                            config.max_len,
                                            prefix_cache=self._share)
        else:
            self.cache_backend = DenseCache(tree, n_rows)
        self.slots = [_Slot() for _ in range(n_rows)]
        self.queue: deque[Request] = deque()
        self.done: list[Completion] = []
        self.greedy = config.greedy
        self.batch_admit = config.batch_admit
        self.chunked = config.chunked
        self._draw = 0                # the random stream's next draw
        self._deadline_abs: dict[int, float] = {}  # rid -> expiry (queued)
        self.steps = 0                # step() calls that found work
        self.chunks = 0               # fused decode chunks run
        self.tokens_generated = 0     # tokens emitted (prefill + decode)
        self.prefill_tokens_executed = 0  # real prompt positions prefilled
        self.prefix_hit_tokens_total = 0  # positions served from hits
        self.busy_s = 0.0             # wall time spent inside step()
        self.peak_active = 0          # most rows active at once
        self.host_reads = 0           # device-to-host reads of picks/chunks
        self.budget_exhausted = False  # last run() hit max_steps with work
        # the card's chunk: its state, the captured step graph, the step's
        # kernel launches (counted at each replay) and the addresses the
        # graph was captured over
        self._buf = None
        self._head = None             # the chunk state's host side
        self._graph = None
        self._tally: dict = {}
        self._addresses: list[int] = []
        self.graph_capture_s: float | None = None
        self.graph_pool_bytes: int | None = None
        self.graph_replays = 0
        if self.device.type == "cuda" and self.chunked:
            with self._on_stream():
                self._buf = model.chunk_buffers(n_rows, self.chunk_tokens)

    def _on_stream(self):
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    # ------------------------------------------------------------------
    def _emit_chunk(self, rid: int, tokens, now: float) -> None:
        if self.on_event is not None:
            self.on_event(ChunkEvent(rid, self.container_id,
                                     tuple(tokens), now))

    def _emit_done(self, comp: Completion, now: float) -> None:
        if self.on_event is not None:
            self.on_event(DoneEvent(comp.rid, self.container_id, comp, now))

    def _emit_fail(self, rid: int, kind: str, reason: str,
                   now: float) -> None:
        if self.on_event is not None:
            self.on_event(FailedEvent(rid, self.container_id, kind, reason,
                                      now))

    def submit(self, req: Request) -> None:
        if req.max_new_tokens <= 0:
            # zero-budget requests complete empty without touching the
            # device (a slot would emit the prefill sample)
            comp = Completion(req.rid, [], len(req.prompt))
            self.done.append(comp)
            self._emit_done(comp, time.perf_counter())
            return
        if req.deadline_s is not None:
            self._deadline_abs[req.rid] = (time.perf_counter()
                                           + req.deadline_s)
        self.queue.append(req)

    def submit_many(self, reqs) -> None:
        for r in reqs:
            self.submit(r)

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or any(s.active for s in self.slots)

    # ------------------------------------------------------------------
    @property
    def _pad_ok(self) -> bool:
        """Right-padding a prompt is harmless only for non-recurrent,
        non-windowed caches (pad K/V slots stay masked until overwritten;
        SSM states and ring windows would absorb the pad tokens)."""
        cfg = self.model.cfg
        return not (cfg.is_ssm or cfg.sliding_window > 0)

    def _width(self, n_tokens: int, lead: int = 0) -> int:
        """Prefill width of ``n_tokens`` prompt positions behind ``lead``
        image positions: the bucket, or the exact length where padding is
        not harmless. Behind an image the bucket is capped at ``max_len -
        lead`` (never below the prompt): past the horizon the cache ring
        would wrap the pad positions over the image's slots, which decode
        reads. A text prompt keeps the JAX engine's width."""
        if not self._pad_ok:
            return n_tokens
        if lead:
            return min(_bucket(n_tokens),
                       max(n_tokens, self.max_len - lead))
        return _bucket(n_tokens)

    @property
    def _row_invariant(self) -> bool:
        """Whether a prefill runs every product on the card in fixed row
        slices, not only float32's (``Model.prefill``'s
        ``row_invariant``): for a model that can share a prefix (the
        dense family without a window), in every engine, so a suffix
        prefill gives a row the whole prompt's bits (sharing on == off)
        and the dense and the paged engine give it the same bits. Not for
        MoE, whose expert capacity couples a batch's rows, nor for an SSM,
        windowed or encoder-decoder model, which never shares: their
        prefills keep one product a projection in every engine."""
        cfg = self.model.cfg
        return self.model.fam == "dense" and cfg.sliding_window == 0

    def _admit_key(self, req: Request) -> tuple:
        """Requests with one key prefill as one batch: the prefill width
        and the names of the request's extras."""
        return (self._width(len(req.prompt), self._nv),
                tuple(sorted(req.extras)))

    def _take_bucket(self, n_free: int) -> list[Request]:
        """Pop the head request plus every queued request with its admit
        key (keeping the queue order of the rest), up to ``n_free``."""
        key = self._admit_key(self.queue[0])
        take: list[Request] = []
        rest: deque[Request] = deque()
        while self.queue and len(take) < n_free:
            r = self.queue.popleft()
            (take if self._admit_key(r) == key else rest).append(r)
        rest.extend(self.queue)
        self.queue = rest
        return take

    def _admit(self) -> None:
        if self.paged:
            self._admit_paged()
            return
        free = [i for i, s in enumerate(self.slots) if not s.active]
        while free and self.queue:
            reqs = (self._take_bucket(len(free)) if self.batch_admit
                    else [self.queue.popleft()])
            self._admit_batch([free.pop(0) for _ in reqs], reqs)

    # -- paged admission ---------------------------------------------------
    @property
    def _nv(self) -> int:
        """Positions the image takes ahead of each prompt (0: text)."""
        return self.model.cfg.n_vision_tokens

    def _cache_tokens(self, req: Request) -> int:
        """Cache positions a request can ever touch: vision prefix +
        prompt + decoded tokens, clamped to the horizon (decode stops at
        max_len - 1)."""
        return min(self._nv + len(req.prompt) + req.max_new_tokens,
                   self.max_len)

    def _block_hashes(self, req: Request) -> list[bytes]:
        """Content hash per FULL block of the sequence (vision prefix,
        then prompt): a chained blake2b seeded with the vision-token count
        (an int64) and the request's extras (each name, then its bytes, in
        name order), then each block's int32 token ids (none for a block
        inside the image) — byte for byte the JAX engine's chain, so a
        hash commits to everything at and before its block."""
        bs, nv = self.config.block_size, self._nv
        seed = hashlib.blake2b(digest_size=16)
        seed.update(np.int64(nv).tobytes())
        for k in sorted(req.extras):
            seed.update(k.encode())
            seed.update(np.ascontiguousarray(
                np.asarray(req.extras[k])).tobytes())
        prev = seed.digest()
        prompt = np.ascontiguousarray(np.asarray(req.prompt), np.int32)
        out: list[bytes] = []
        for i in range((nv + len(prompt)) // bs):
            hh = hashlib.blake2b(prev, digest_size=16)
            hh.update(prompt[max(i * bs - nv, 0):
                             max((i + 1) * bs - nv, 0)].tobytes())
            prev = hh.digest()
            out.append(prev)
        return out

    def _peek_plan(self, req: Request):
        """Sharing plan ``(H, hit_hashes, full_hashes)``: ``H`` sequence
        positions are cache hits, capped one block below the sequence end
        so at least one residual token runs (the prefill sample needs it),
        and 0 when the hit does not cover the vision prefix (the suffix
        prefill embeds text only)."""
        bs, nv = self.config.block_size, self._nv
        full = self._block_hashes(req)
        hits = self.cache_backend.peek_hit_blocks(full)
        H = min(len(hits), (nv + len(req.prompt) - 1) // bs) * bs
        if H < nv:
            H = 0
        return H, full[:H // bs], full

    def _key_for(self, req: Request, plan) -> tuple:
        """Paged admit key: requests prefill as one batch only when their
        padded width matches — for a hit, the SUFFIX bucket, with the hit
        length folded in so a batch shares one context width and rope
        offset (hit and miss requests never share a dispatch)."""
        if plan is None or plan[0] == 0:
            return self._admit_key(req)
        return (_bucket(self._nv + len(req.prompt) - plan[0]),
                tuple(sorted(req.extras)), plan[0])

    def _admit_paged(self) -> None:
        """Block-budget admission, strict FIFO: pop queue heads while a
        free row AND enough blocks exist, batching the run of consecutive
        heads that share an admit key into one prefill (one head a
        prefill with ``batch_admit=False``). A head that does
        not fit stops admission (nothing is scanned past it). Rows freed
        during the round park in the cache's pending list; they are
        flushed before the free rows are recomputed, so a reservation is
        refused only once nothing is left to reclaim."""
        cb = self.cache_backend
        cb.flush()   # scrub freed rows' tables, reclaim their blocks
        free = [i for i, s in enumerate(self.slots) if not s.active]
        while free and self.queue:
            head_plan = (self._peek_plan(self.queue[0]) if self._share
                         else None)
            key = self._key_for(self.queue[0], head_plan)
            take: list[Request] = []
            slot_ids: list[int] = []
            plans: list = []
            blocked: bool | str = False
            limit = len(free) if self.batch_admit else 1
            while self.queue and free and len(take) < limit:
                req = self.queue[0]
                plan = self._peek_plan(req) if self._share else None
                if self._key_for(req, plan) != key:
                    break
                if self.fault is not None and self.fault.refuse_alloc():
                    blocked = "fault"    # injected pool exhaustion
                    break
                hashes = plan[1] if plan is not None else ()
                if not cb.alloc(free[0], self._cache_tokens(req),
                                block_hashes=hashes):
                    blocked = True
                    break
                slot_ids.append(free.pop(0))
                take.append(self.queue.popleft())
                plans.append(plan)
            if take:
                self._admit_batch(slot_ids, take, plans)
            if blocked == "fault":
                return
            if blocked and not cb._pending:
                return     # exhausted: FIFO holds the head until a finish
            if not take and not blocked:
                return
            # an instant finish inside _admit_batch parks its row; flush
            # so the recomputed free rows hold no reservation
            if cb._pending:
                cb.flush()
            free = [i for i, s in enumerate(self.slots) if not s.active]

    # ------------------------------------------------------------------
    def _admit_batch(self, slot_ids: list[int], reqs: list[Request],
                     plans: list | None = None) -> None:
        n, nv = len(reqs), self._nv
        H = plans[0][0] if plans and plans[0] is not None else 0
        # prompts (or, for a hit, their suffixes behind H shared positions,
        # which cover any vision prefix) right-padded into one batch of the
        # admit key's width; a prompt's image goes ahead of it (``lead``
        # positions)
        lead = 0 if H else nv
        bl = (self._width(nv + len(reqs[0].prompt) - H) if H
              else self._width(len(reqs[0].prompt), nv))
        padded = np.zeros((n, bl), np.int32)
        logits_idx = np.zeros((n,), np.int64)
        for j, r in enumerate(reqs):
            toks = np.asarray(r.prompt)[H - nv if H else 0:]
            padded[j, :len(toks)] = toks
            logits_idx[j] = lead + len(toks) - 1
        tokens = torch.from_numpy(padded).to(self.device)
        logits_at = torch.from_numpy(logits_idx).to(self.device)
        dtype = self.config.dtype
        if H:
            # every row shares hit length H (it is in the admit key), so
            # one gathered context of width exactly H serves the batch;
            # gather before insert rewrites these rows' tables
            ctx = self.cache_backend.gather_prefix(slot_ids, H)
            src = self.model.init_cache(n, bl, dtype)
            logits = self.model.prefill_suffix(
                self.params, tokens, src, ctx, H, logits_at=logits_at,
                row_invariant=self._row_invariant)
            self.prefix_hit_tokens_total += n * H
        else:
            # the paged mini-cache's full-horizon groups are bucket-wide
            # (JAX builds them max_len wide): positions at or past a
            # row's length are never read, so the rest of the horizon
            # need not be zero-filled. They are capped at max_len, where
            # a text bucket past the horizon wraps its padding into the
            # ring exactly as the dense cache does (behind an image the
            # width stops at the horizon, ``_width``). A sliding ring is as wide
            # as the engine's (min(window, max_len)) under either cache,
            # so a prompt longer than the window wraps into the slots the
            # engine decodes from, and insert copies the ring whole
            width = (min(lead + bl, self.max_len) if self.paged
                     else self.max_len)
            src = self.model.init_cache(n, self.max_len, dtype,
                                        width=width)
            # each request's image or frames, stacked (the admit key holds
            # the extras' names, so every request of the batch has them)
            kw = {k: torch.from_numpy(np.stack([
                np.asarray(r.extras[k]) for r in reqs])).to(self.device)
                for k in MODEL_INPUTS if k in reqs[0].extras}
            logits = self.model.prefill(self.params, tokens, src,
                                        logits_at=logits_at,
                                        row_invariant=self._row_invariant,
                                        **kw)
        self.cache_backend.insert(src, slot_ids, offset=H)
        self.prefill_tokens_executed += sum(nv + len(r.prompt) - H
                                            for r in reqs)
        if self._share:
            # index the new rows' full prompt blocks (hit rows extend the
            # chain past their hit; indexed hashes are skipped)
            for i, pl in zip(slot_ids, plans):
                self.cache_backend.register_prefix(i, pl[2])
        first = self._pick(logits)
        now = time.perf_counter()
        for j, (i, r) in enumerate(zip(slot_ids, reqs)):
            # prompt_len leaves the image out; pos is the next write
            self.slots[i] = _Slot(
                active=True, rid=r.rid, pos=nv + len(r.prompt),
                prompt_len=len(r.prompt), remaining=r.max_new_tokens - 1,
                generated=[int(first[j])], started=now,
                deadline=self._deadline_abs.pop(r.rid, None),
                hit_tokens=H)
            self.tokens_generated += 1
            # the prefill sample is the request's first streamed chunk
            self._emit_chunk(r.rid, (int(first[j]),), now)
        self.peak_active = max(self.peak_active,
                               sum(1 for s in self.slots if s.active))
        for i in slot_ids:
            if self.slots[i].active and self.slots[i].remaining <= 0:
                self._finish(i)

    def _key(self) -> torch.Tensor:
        """The random stream's state now, on the engine's device."""
        return new_key(self.config.seed, self._draw, self.device)

    @property
    def draws(self) -> int:
        """Draws the random stream has given (one a sampled pick)."""
        return self._draw

    def _pick(self, logits: torch.Tensor) -> np.ndarray:
        """Each row's token on the host: the argmax, or one sample of the
        stream's next draw."""
        if self.greedy:
            picked = torch.argmax(logits, dim=-1)
        else:
            picked = gumbel_argmax(logits, self._key())
            self._draw += 1
        self.host_reads += 1
        return picked.cpu().numpy()

    def cancel(self, rid: int) -> bool:
        """Remove a request from the engine — queued or mid-decode — and
        free its cache reservation (paged: through the deferred
        ``free``/``flush`` path, so block conservation stays exact). Emits
        NO event: the canceller (the Router, or a backend's ``cancel``)
        owns the request's terminal event. Returns whether the request was
        found."""
        self._deadline_abs.pop(rid, None)
        for r in self.queue:
            if r.rid == rid:
                self.queue = deque(q for q in self.queue if q.rid != rid)
                return True
        for i, s in enumerate(self.slots):
            if s.active and s.rid == rid:
                self.cache_backend.free(i)
                self.slots[i] = _Slot()
                return True
        return False

    def _expire_deadlines(self) -> None:
        """Fail every queued or active request whose deadline passed with
        a ``FailedEvent(kind="deadline")``. Runs at the top of each step,
        before admission, so an expiry frees its slot (paged: its blocks,
        through the deferred free that admission's flush reclaims)."""
        now = time.perf_counter()
        if self._deadline_abs:
            expired = {rid for rid, t in self._deadline_abs.items()
                       if now > t}
            if expired:
                self.queue = deque(r for r in self.queue
                                   if r.rid not in expired)
                for rid in expired:
                    del self._deadline_abs[rid]
                    self._emit_fail(rid, "deadline",
                                    "deadline expired while queued", now)
        for i, s in enumerate(self.slots):
            if s.active and s.deadline is not None and now > s.deadline:
                self._emit_fail(s.rid, "deadline",
                                f"deadline expired mid-decode after "
                                f"{len(s.generated)} tokens", now)
                self.cache_backend.free(i)
                self.slots[i] = _Slot()

    def _finish(self, i: int) -> None:
        s = self.slots[i]
        now = time.perf_counter()
        comp = Completion(s.rid, s.generated, s.prompt_len, now - s.started,
                          prefix_hit_tokens=s.hit_tokens)
        self.done.append(comp)
        self._emit_done(comp, now)
        # paged: the row's blocks return at the next admission flush,
        # after its table points at scratch again
        self.cache_backend.free(i)
        self.slots[i] = _Slot()

    # ------------------------------------------------------------------
    def _decode_chunk(self, active: list[int]) -> None:
        """One fused macro-step over every active slot, then a single
        device-to-host transfer of the token block and emitted counts."""
        exact = max(1, min(
            self.chunk_tokens,
            min(self.slots[i].remaining for i in active),
            min(self.max_len - 1 - self.slots[i].pos for i in active)))
        # round down to a power of two: never a step past the shortest
        # budget, and the same few chunk lengths recur
        n_tokens = 1 << (exact.bit_length() - 1)
        state = np.zeros((4, len(self.slots)), np.int32)  # tok, pos, rem, act
        for i in active:
            s = self.slots[i]
            state[:, i] = (s.generated[-1], s.pos, s.remaining, 1)
        block, emitted = self._run_chunk(state, n_tokens)
        now = time.perf_counter()
        for i in active:
            s = self.slots[i]
            c = int(emitted[i])
            new = block[i, :c].tolist()
            s.generated.extend(new)
            s.pos += c
            s.remaining -= c
            self.tokens_generated += c
            if new:
                self._emit_chunk(s.rid, new, now)
            if s.remaining <= 0 or s.pos >= self.max_len - 1:
                self._finish(i)
        self.chunks += 1

    def _run_chunk(self, state: np.ndarray,
                   n_tokens: int) -> tuple[np.ndarray, np.ndarray]:
        """``n_tokens`` steps from ``state`` (tokens, pos, remaining,
        active of every row, (4, rows) int32) and the random stream's
        state: the token block (rows, n_tokens) and emitted counts (rows,)
        on the host. A sampling chunk takes ``n_tokens`` draws."""
        self.host_reads += 1
        if self._buf is None:
            dev = torch.from_numpy(state).to(self.device)
            st = {"tokens": dev[0], "pos": dev[1], "remaining": dev[2],
                  "active": dev[3].bool()}
            kw = {}
            if not self.greedy:
                st["key"], kw["greedy"] = self._key(), False
                self._draw += n_tokens
            block, emitted, _ = self.model.decode_chunk(
                self.params, self.cache_backend.tree, st, n_tokens,
                max_len=self.max_len, **kw)
            host = torch.cat([block, emitted[:, None]], dim=1).cpu().numpy()
            return host[:, :-1], host[:, -1]
        B = state.shape[1]
        if self._head is None:
            # pinned on the card: the copy below is queued on the stream,
            # not waited for. Rewriting the buffer at the next chunk is
            # safe: this chunk's read-back below drains the stream first
            self._head = torch.zeros(5 * B + 6, dtype=torch.int32,
                                     pin_memory=self.device.type == "cuda")
        # tokens, pos, remaining, active | col (0) | key | emitted (0)
        head = self._head.numpy()
        head[:] = 0
        head[:4 * B] = state.reshape(-1)
        head[4 * B + 2:4 * B + 6].view(np.int64)[:] = new_key(
            self.config.seed, self._draw).numpy()
        self._buf["head"].copy_(self._head, non_blocking=True)
        if not self.greedy:
            self._draw += n_tokens
        replays = n_tokens
        if self._graph is None:
            # the first step runs eagerly on the engine's stream (its
            # first cuBLAS calls and module loads happen outside any
            # capture) and counts as a real step; then the capture
            self._step()
            self._capture()
            replays -= 1
        else:
            self._check_addresses()
        for _ in range(replays):
            self._graph.replay()
        add_launches(self._tally, replays)
        self.graph_replays += replays
        out = self._buf["out"][:B * (n_tokens + 1)].cpu().numpy()
        return out[B:].reshape(n_tokens, B).T, out[:B]

    def _step(self) -> None:
        self.model.decode_chunk_step(self.params, self.cache_backend.tree,
                                     self._buf, max_len=self.max_len,
                                     greedy=self.greedy)

    def graph_leaves(self) -> list[tuple[str, torch.Tensor]]:
        """(path, tensor) of everything the chunk step reads or writes by
        address: every cache leaf (the paged block table once per layer
        group), every weight and the chunk state."""
        return [*_tensors(self.cache_backend.tree, "cache"),
                *_tensors(self.params, "params"),
                *_tensors(self._buf or {}, "chunk")]

    def _capture(self) -> None:
        """Capture one chunk step on the engine's stream (its launches go
        to the tally a replay counts), and record what it holds by
        address."""
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with _CAPTURE_LOCK, capture_tally() as tally:
            with torch.cuda.graph(graph, stream=self.stream,
                                  capture_error_mode="thread_local"):
                reserved = torch.cuda.memory_reserved(self.device)
                self._step()
                self.graph_pool_bytes = (
                    torch.cuda.memory_reserved(self.device) - reserved)
        self.graph_capture_s = time.perf_counter() - t0
        self._graph, self._tally = graph, tally
        self._addresses = [t.data_ptr() for _, t in self.graph_leaves()]

    def _check_addresses(self) -> None:
        """Raise before a replay if a tensor the graph was captured over
        is gone or has moved: a replay would read and write the old
        address."""
        leaves = self.graph_leaves()
        now = [t.data_ptr() for _, t in leaves]
        if now != self._addresses:
            moved = ([p for (p, _), a, b in zip(leaves, now, self._addresses)
                      if a != b] if len(now) == len(self._addresses)
                     else [f"{len(self._addresses)} tensors at capture, "
                           f"{len(now)} now"])
            raise RuntimeError(
                f"the engine's decode graph holds tensors by address, and "
                f"{moved[:4]} moved since its capture; caches, weights "
                "and the chunk state must be updated in place")

    def _decode_token(self, active: list[int]) -> None:
        """The per-token baseline: one eager ``Model.decode_step`` over
        every row (inactive rows at token 0, position 0, as in JAX), one
        pick and one host read per generated token, and one ChunkEvent per
        request per token. No graph: this is what the fused chunk is
        measured against."""
        n_rows = len(self.slots)
        tokens = np.zeros((n_rows, 1), np.int32)
        pos = np.zeros((n_rows,), np.int32)
        for i in active:
            s = self.slots[i]
            tokens[i, 0] = s.generated[-1]
            pos[i] = s.pos
        logits = self.model.decode_step(
            self.params, torch.from_numpy(tokens).to(self.device),
            self.cache_backend.tree, torch.from_numpy(pos).to(self.device))
        nxt = self._pick(logits)
        now = time.perf_counter()
        for i in active:
            s = self.slots[i]
            s.generated.append(int(nxt[i]))
            s.pos += 1
            s.remaining -= 1
            self.tokens_generated += 1
            self._emit_chunk(s.rid, (int(nxt[i]),), now)
            if s.remaining <= 0 or s.pos >= self.max_len - 1:
                self._finish(i)

    # ------------------------------------------------------------------
    def step(self) -> bool:
        """One macro-iteration: expire deadlines, admit, then one decode
        chunk (one decode step with ``chunked=False``). Returns whether
        the engine still has work."""
        if not self.has_work:
            return False
        self.steps += 1
        if self.fault is not None:
            self.fault.on_step(self.steps)   # may raise InjectedFault
        t0 = time.perf_counter()
        with self._on_stream():
            self._expire_deadlines()
            self._admit()
            active = [i for i, s in enumerate(self.slots) if s.active]
            if active:
                if self.chunked:
                    self._decode_chunk(active)
                else:
                    self._decode_token(active)
        self.busy_s += time.perf_counter() - t0
        return self.has_work

    def run(self, max_steps: int = 10_000) -> list[Completion]:
        """Drive until idle (or ``max_steps`` ``step()`` calls for this
        call) and return the finished completions. Exhausting the budget
        with work left sets ``budget_exhausted`` and warns; a run that
        drains clears the flag."""
        start = self.steps
        while self.has_work and self.steps - start < max_steps:
            self.step()
        self.budget_exhausted = self.has_work
        if self.budget_exhausted:
            n_active = sum(1 for s in self.slots if s.active)
            warnings.warn(
                f"ServingEngine.run() exhausted max_steps={max_steps} with "
                f"{len(self.queue)} queued and {n_active} active requests "
                "remaining; returning partial completions "
                "(engine.budget_exhausted is set)", RuntimeWarning,
                stacklevel=2)
        out, self.done = self.done, []
        return out
