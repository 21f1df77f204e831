"""The fused decode chunk's one body, and what its CUDA graph relies on.

* ``Model.decode_chunk`` is ``n_tokens`` calls of ``decode_chunk_step``,
  and gives JAX's ``decode_chunk`` tokens, emitted counts and state
  exactly, over every cache kind the port serves: dense, paged, int8
  dense and paged, mamba2's state rows, and the MLA latent cache dense
  and paged. Both sides decode from the same cache bytes (the port's
  prefill, stacked into JAX's layer layout), with ragged budgets, an
  idle slot and a slot that reaches ``max_len - 1`` mid-chunk.
* The launch counters' capture tally: launches made while a thread
  captures are counted only when a replay adds them, and two threads'
  tallies never mix.
* Every tensor the engine's step graph holds by address keeps its
  ``data_ptr()`` across admissions, ``cancel``, ``flush``, a
  copy-on-write fork and a row's re-admission, on dense and paged
  engines.
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro_torch import params as bridge  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.models.cache import PagedLayout  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving.cache import PagedCache  # noqa: E402
from repro_torch.serving.engine import (EngineConfig, Request,  # noqa: E402
                                        ServingEngine)

B, PROMPT, MAX_LEN, STEPS = 3, 16, 24, 8
LAYOUT = PagedLayout(block_size=8, max_blocks=12)
# (arch, int8 KV cache, paged)
KINDS = {"dense": ("qwen3-0.6b-reduced", False, False),
         "paged": ("qwen3-0.6b-reduced", False, True),
         "int8_dense": ("qwen3-0.6b-reduced", True, False),
         "int8_paged": ("qwen3-0.6b-reduced", True, True),
         "mamba2": ("mamba2-2.7b-reduced", False, False),
         "mla_dense": ("deepseek-v2-lite-16b-reduced", False, False),
         "mla_paged": ("deepseek-v2-lite-16b-reduced", False, True)}


@pytest.fixture(scope="module")
def weights():
    """JAX parameters per arch (seed 0) and their numpy leaves."""
    out = {}
    for name in {arch for arch, _, _ in KINDS.values()}:
        jp = JaxModel(jax_config(name)).init(jax.random.PRNGKey(0))
        out[name] = (jp, jax.tree.map(np.asarray, jp))
    return out


def _jax_cache(tm: Model, tree: list) -> dict:
    """The port's per-layer cache groups stacked into JAX's layout (an
    MoE model's leading dense layers as ``dense0``)."""
    def stack(groups):
        return {k: jnp.asarray(np.stack([g[k].numpy() for g in groups]))
                for k in groups[0]}
    n = tm.n_dense_layers if tm.fam == "moe" else 0
    out = {"stack": stack(tree[n:])}
    if n:
        out["dense0"] = stack(tree[:n])
    return out


def _prefilled(tm: Model, tp: dict, paged: bool):
    """Three prompts prefilled by the port (rows 0 and 2 to position 15,
    row 1 to 9; an SSM model's all to 15, unpadded), in a dense cache or
    scattered into pages where row 1, the idle slot, holds no block and
    writes into the scratch page. Returns (cache, first tokens, last
    positions)."""
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, tm.cfg.vocab_size,
                                         (B, PROMPT), dtype=np.int32))
    last = (np.array([15, 15, 15], np.int32) if tm.fam == "ssm"
            else np.array([15, 9, 15], np.int32))
    width = PROMPT if paged else MAX_LEN
    src = tm.init_cache(B, width)
    logits = tm.prefill(tp, toks, src, logits_at=torch.from_numpy(last))
    first = torch.argmax(logits, dim=-1).to(torch.int32)
    if not paged:
        return src, first, last
    tree = tm.init_cache(B, MAX_LEN, layout=LAYOUT)
    pc = PagedCache(tree, B, LAYOUT, MAX_LEN)
    for row in (0, 2):
        assert pc.alloc(row, MAX_LEN)
    pc.insert([{k: t[[0, 2]] for k, t in g.items()} for g in src], [0, 2])
    return tree, first, last


@pytest.mark.parametrize("kind", list(KINDS))
def test_decode_chunk_is_its_step_looped_and_matches_jax(kind, weights,
                                                        monkeypatch):
    arch, int8, paged = KINDS[kind]
    jcfg, tcfg = jax_config(arch), get_config(arch)
    if int8:
        jcfg = dataclasses.replace(jcfg, kv_cache_dtype="int8")
        tcfg = dataclasses.replace(tcfg, kv_cache_dtype="int8")
    jp, tree = weights[arch]
    jm, tm = JaxModel(jcfg), Model(tcfg, device="cpu")
    tp = bridge.from_numpy(tcfg, tree, device="cpu")
    cache, first, last = _prefilled(tm, tp, paged)
    jc = _jax_cache(tm, cache)
    state = {"tokens": first.numpy(), "pos": last + 1,
             "remaining": np.array([3, 5, 20], np.int32),
             "active": np.array([True, False, True])}

    steps = []
    body = tm.decode_chunk_step

    def spy(*args, **kw):
        steps.append(kw["max_len"])
        return body(*args, **kw)
    monkeypatch.setattr(tm, "decode_chunk_step", spy)
    tblock, temit, tstate = tm.decode_chunk(
        tp, cache, {k: torch.from_numpy(v) for k, v in state.items()},
        STEPS, max_len=MAX_LEN)
    assert steps == [MAX_LEN] * STEPS

    jblock, jemit, jstate, _ = jm.decode_chunk(
        jp, jc, dict({k: jnp.asarray(v) for k, v in state.items()},
                     key=jax.random.PRNGKey(0)), STEPS, max_len=MAX_LEN)
    # slot 0 spends its budget, slot 1 idles, slot 2 stops at the horizon
    assert temit.tolist() == np.asarray(jemit).tolist() == [3, 0, 7]
    assert tblock.shape == (B, STEPS)
    for i, n in enumerate(temit.tolist()):
        assert tblock[i, :n].tolist() == np.asarray(jblock)[i, :n].tolist()
    for k in ("tokens", "pos", "remaining", "active"):
        assert tstate[k].tolist() == np.asarray(jstate[k]).tolist(), k
    assert tstate["active"].dtype == torch.bool


def test_launches_in_a_capture_tally_count_only_when_added():
    ops.reset_launch_counts()
    norm, dec = ops.COUNTERS["rmsnorm"], ops.COUNTERS["decode_attention"]
    with build.capture_tally() as tally:
        norm.add()
        norm.add()
        dec.add()
        assert ops.launch_counts()["rmsnorm"] == 0
    assert tally == {norm: 2, dec: 1}
    norm.add()                       # launched outside any capture
    assert ops.launch_counts()["rmsnorm"] == 1
    build.add_launches(tally, 3)     # three replays
    build.add_launches(tally, 0)
    counts = ops.launch_counts()
    assert (counts["rmsnorm"], counts["decode_attention"]) == (7, 3)
    assert sum(counts.values()) == 10
    ops.reset_launch_counts()


def test_two_threads_tallies_never_mix():
    ops.reset_launch_counts()
    norm, dec = ops.COUNTERS["rmsnorm"], ops.COUNTERS["decode_attention"]
    flash = ops.COUNTERS["flash_attention"]
    both_open, done = threading.Barrier(3), threading.Barrier(3)
    tallies = {}

    def capture(name, counter, n):
        with build.capture_tally() as tally:
            both_open.wait()
            for _ in range(n):
                counter.add()
            done.wait()          # the other thread adds meanwhile
        tallies[name] = tally

    workers = [threading.Thread(target=capture, args=("a", norm, 5)),
               threading.Thread(target=capture, args=("b", dec, 3))]
    for w in workers:
        w.start()
    both_open.wait()
    flash.add()
    flash.add()                  # this thread captures nothing
    done.wait()
    for w in workers:
        w.join()
    assert tallies == {"a": {norm: 5}, "b": {dec: 3}}
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 2 and sum(counts.values()) == 2
    ops.reset_launch_counts()


def _addresses(engine) -> dict:
    return {p: t.data_ptr() for p, t in engine.graph_leaves()}


@pytest.fixture(scope="module")
def port_model():
    tm = Model(get_config("qwen3-0.6b-reduced"), device="cpu")
    return tm, tm.init(seed=0)


def test_dense_engine_keeps_every_address(port_model):
    tm, tp = port_model
    eng = ServingEngine(tm, tp, EngineConfig(n_slots=2, max_len=64,
                                             chunk_tokens=4), device="cpu")
    want = _addresses(eng)
    # k and v of every layer and every weight; no chunk state on the CPU
    assert sum(p.startswith("cache") for p in want) == 2 * tm.cfg.n_layers
    assert sum(p.startswith("params") for p in want) > 2 * tm.cfg.n_layers
    assert not any(p.startswith("chunk") for p in want)
    rng = np.random.default_rng(0)

    def req(rid, n, m):
        return Request(rid, rng.integers(0, tm.cfg.vocab_size, (n,),
                                         dtype=np.int32), m)
    eng.submit_many([req(0, 9, 12), req(1, 20, 12)])
    eng.step()                                  # admission + a chunk
    assert _addresses(eng) == want
    assert eng.cancel(0)                        # mid-decode
    assert _addresses(eng) == want
    eng.submit(req(2, 5, 6))                    # re-admission into row 0
    eng.step()
    assert eng.slots[0].rid == 2
    assert _addresses(eng) == want
    eng.run()
    assert _addresses(eng) == want


def test_paged_engine_keeps_every_address(port_model):
    tm, tp = port_model
    eng = ServingEngine(tm, tp, EngineConfig(
        n_slots=2, max_len=128, chunk_tokens=4, cache="paged",
        block_size=16, prefix_cache=True, max_seqs=4), device="cpu")
    cb = eng.cache_backend
    want = _addresses(eng)
    table = cb._table
    rng = np.random.default_rng(1)
    prefix = rng.integers(0, tm.cfg.vocab_size, (48,), dtype=np.int32)

    def req(rid, n, m):
        return Request(rid, np.concatenate([prefix, rng.integers(
            0, tm.cfg.vocab_size, (n,), dtype=np.int32)]), m)
    eng.submit(req(0, 9, 3))
    eng.run()                                   # indexes the prefix
    eng.submit_many([req(1, 20, 12), req(2, 3, 12)])
    eng.step()                                  # admissions with hits
    assert eng.prefix_hit_tokens_total > 0
    assert _addresses(eng) == want
    row = next(i for i, s in enumerate(eng.slots) if s.active
               and cb.allocator.ref(cb._blocks[i][0]) > 1)
    before = table[row, 0].item()
    assert cb._cow_fork(row, 0)                 # copy-on-write fork
    assert table[row, 0].item() != before
    assert _addresses(eng) == want
    assert eng.cancel(eng.slots[row].rid)
    cb.flush()                                  # scrub + reclaim
    assert (table[row] == eng.layout.scratch_page).all()
    assert _addresses(eng) == want
    eng.submit(req(3, 30, 12))                  # re-admission of the row
    eng.step()
    assert eng.slots[row].rid == 3
    assert _addresses(eng) == want
    eng.run()
    assert _addresses(eng) == want
    assert all(g["table"] is table for g in cb.tree)



class _ReplayedStep:
    """Stands in for the CUDA graph on the CPU: a replay runs the step."""

    def __init__(self, step):
        self.replay = step


def test_card_chunk_path_with_a_stand_in_graph_serves_the_cpu_streams(
        port_model):
    """The card's chunk path (one state write, the first step eager, then
    replays, one read of the emitted counts and token block) with a
    stand-in graph gives ``Model.decode_chunk``'s streams, ragged budgets
    and re-admissions included."""
    tm, tp = port_model
    config = EngineConfig(n_slots=3, max_len=40, chunk_tokens=8)
    plain = ServingEngine(tm, tp, config, device="cpu")
    card = ServingEngine(tm, tp, config, device="cpu")
    card._buf = tm.chunk_buffers(config.n_rows, config.chunk_tokens)
    captures = []

    def capture():
        captures.append(card.graph_replays)
        card._graph = _ReplayedStep(card._step)
        card._addresses = [t.data_ptr() for _, t in card.graph_leaves()]
    card._capture = capture
    rng = np.random.default_rng(3)
    specs = [(9, 12), (20, 3), (5, 30), (17, 1), (30, 20), (4, 7)]
    reqs = [Request(i, rng.integers(0, tm.cfg.vocab_size, (n,),
                                    dtype=np.int32), m)
            for i, (n, m) in enumerate(specs)]
    streams = []
    for eng in (plain, card):
        eng.submit_many([dataclasses.replace(r) for r in reqs])
        streams.append({c.rid: list(c.tokens) for c in eng.run()})
    assert streams[0] == streams[1]
    # every budget is spent but request 4's, which meets the horizon
    assert [len(streams[1][r.rid]) for r in reqs] == [12, 3, 30, 1, 10, 7]
    assert captures == [0] and card.graph_replays > 0
    assert card.chunks == plain.chunks
