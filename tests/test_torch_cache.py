"""The port's block allocator and paged cache.

Three parts:

* the properties of tests/test_block_allocator_props.py (hypothesis) on
  the port's ``BlockAllocator`` and ``PagedCache``: pool conservation,
  all-or-nothing alloc, double and foreign frees raise, and the
  refcount invariants of share / copy-on-write / evict interleavings;
* a differential test: one seeded random sequence of alloc (with block
  hashes), insert, append, free, flush and register_prefix through the
  JAX ``PagedCache`` and the port's, on real page tensors. After every
  op the host state (block lists, refcounts, free list, LRU order, hash
  index), the block table and every page but the scratch page are equal;
* the copy-on-write fork reaching the k and v pages of every layer, the
  int8 scale pages and an MLA layer's latent and rope-key pages, whose
  page groups have one trailing axis fewer (tests/test_paged_cache.py's
  regressions on the page axis), and ``gather_prefix`` and ``insert``
  reading and writing them through the table.
"""
from __future__ import annotations

import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")

import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.models.cache import PagedLayout as JaxLayout  # noqa: E402
from repro.serving.cache import PagedCache as JaxPagedCache  # noqa: E402
from repro_torch.models.cache import (PagedLayout,  # noqa: E402
                                      init_paged_attn_cache,
                                      init_paged_mla_cache, new_table)
from repro_torch.serving.cache import BlockAllocator, PagedCache  # noqa: E402


# ---------------------------------------------------------------------------
# properties (the cases of tests/test_block_allocator_props.py)
# ---------------------------------------------------------------------------
@given(st.integers(1, 64), st.lists(st.integers(0, 70), max_size=40),
       st.randoms())
@settings(max_examples=100, deadline=None)
def test_alloc_free_roundtrip_conserves_pool(n_blocks, sizes, rnd):
    a = BlockAllocator(n_blocks)
    live: list[list[int]] = []
    for n in sizes:
        if live and rnd.random() < 0.4:
            a.free(live.pop(rnd.randrange(len(live))))
        free_now = n_blocks - sum(map(len, live))
        got = a.alloc(n)
        if n > free_now:
            assert got is None
        if got is None:
            assert a.n_free == free_now      # refused: no side effect
            continue
        assert len(got) == n
        live.append(got)
        flat = [b for r in live for b in r]
        assert len(flat) == len(set(flat)), "aliased live blocks"
        assert all(0 <= b < n_blocks for b in flat)
        assert a.n_free == n_blocks - len(flat)
    for r in live:
        a.free(r)
    assert a.n_free == n_blocks


@given(st.integers(1, 32), st.integers(1, 32))
@settings(max_examples=50, deadline=None)
def test_all_or_nothing(n_blocks, n):
    a = BlockAllocator(n_blocks)
    got = a.alloc(n)
    if n <= n_blocks:
        assert got is not None and a.n_free == n_blocks - n
    else:
        assert got is None and a.n_free == n_blocks


@given(st.integers(1, 32), st.integers(1, 8))
@settings(max_examples=50, deadline=None)
def test_double_and_foreign_free_raise(n_blocks, n):
    a = BlockAllocator(n_blocks)
    got = a.alloc(min(n, n_blocks))
    a.free(got)
    with pytest.raises(ValueError):
        a.free(got)
    with pytest.raises(ValueError):
        a.free([n_blocks + 7])
    with pytest.raises(ValueError):
        a.share([n_blocks + 7])
    assert a.n_free == n_blocks


@given(st.integers(1, 12), st.integers(1, 8), st.integers(1, 64),
       st.lists(st.tuples(st.sampled_from(["admit", "grow", "complete",
                                           "expire", "cancel", "flush"]),
                          st.integers(0, 11), st.integers(1, 24)),
                max_size=60),
       st.randoms())
@settings(max_examples=100, deadline=None)
def test_release_interleavings_conserve_blocks(n_rows, block_size,
                                               max_blocks, ops, rnd):
    layout = PagedLayout(block_size=block_size, max_blocks=max_blocks)
    max_len = block_size * max_blocks
    cache = PagedCache([], n_rows, layout, max_len)
    held: set[int] = set()

    def check():
        assert (cache.allocator.n_free + cache.n_live_blocks
                == max_blocks), "leaked or double-freed blocks"
        flat = [b for r in cache._blocks for b in r]
        assert len(flat) == len(set(flat)), "aliased live blocks"

    for op, row, toks in ops:
        row %= n_rows
        if op == "admit":
            if row not in held and cache.alloc(row, min(toks, max_len)):
                held.add(row)
        elif op == "grow":
            if row in held and row not in cache._pending:
                cache.append(row, 1)
        elif op == "flush":
            cache.flush()
            held -= {r for r in range(n_rows) if not cache._blocks[r]}
        else:                    # racing releases must be idempotent
            for _ in range(rnd.randint(1, 2)):
                cache.free(row)
        check()
    for row in range(n_rows):
        cache.free(row)
    cache.flush()
    assert cache.allocator.n_free == max_blocks
    assert cache.n_live_blocks == 0


def _chain(content) -> list[tuple]:
    """Stand-in block-hash chain: equal leading content, equal hashes."""
    return [tuple(content[:i + 1]) for i in range(len(content))]


@given(st.integers(1, 6), st.integers(1, 4), st.integers(2, 16),
       st.lists(st.tuples(st.sampled_from(["admit", "register", "grow",
                                           "release", "flush"]),
                          st.integers(0, 5),
                          st.lists(st.integers(0, 2), min_size=1,
                                   max_size=5),
                          st.integers(0, 3)),
                max_size=50),
       st.randoms())
@settings(max_examples=100, deadline=None)
def test_share_cow_evict_interleavings_conserve_refcounts(
        n_rows, block_size, max_blocks, ops, rnd):
    layout = PagedLayout(block_size=block_size, max_blocks=max_blocks)
    max_len = block_size * max_blocks
    cache = PagedCache([], n_rows, layout, max_len, prefix_cache=True)
    chains: dict[int, list] = {}

    def check():
        assert (cache.allocator.n_free + cache.n_live_blocks
                == max_blocks), "leaked or double-freed blocks"
        refs: dict[int, int] = {}
        for blocks in cache._blocks:
            for b in blocks:
                refs[b] = refs.get(b, 0) + 1
        for b in cache._block_hash:
            refs[b] = refs.get(b, 0) + 1
        assert {b: cache.allocator.ref(b) for b in refs} == refs
        assert cache.allocator._ref.keys() == refs.keys()
        for b in cache._lru:                 # LRU holds index-only blocks
            assert b in cache._block_hash and cache.allocator.ref(b) == 1
        assert ({h: b for b, h in cache._block_hash.items()}
                == cache._hash_to_block)

    for op, row, content, extra in ops:
        row %= n_rows
        live = cache._blocks[row] and row not in cache._pending
        if op == "admit" and not cache._blocks[row] \
                and row not in cache._pending:
            n_tokens = min(len(content) * block_size + extra, max_len)
            if n_tokens and cache.alloc(row, n_tokens,
                                        block_hashes=_chain(content)):
                chains[row] = _chain(content)
        elif op == "register" and live and row in chains:
            cache.register_prefix(row, chains[row])
        elif op == "grow" and live:
            old = cache._tokens[row]
            if cache.append(row, extra + 1):
                # every block the write lands in is private afterwards
                for idx in range(old // block_size,
                                 min((cache._tokens[row] - 1) // block_size
                                     + 1, len(cache._blocks[row]))):
                    b = cache._blocks[row][idx]
                    assert cache.allocator.ref(b) == 1
                    assert b not in cache._block_hash
        elif op == "release":
            for _ in range(rnd.randint(1, 2)):
                cache.free(row)
        elif op == "flush":
            cache.flush()
        check()
    cache.flush()
    for row in range(n_rows):
        cache.free(row)
    cache.flush()
    check()
    for b in list(cache._lru):
        cache._evict(b)
    assert not cache._block_hash
    assert cache.allocator.n_free == max_blocks


# ---------------------------------------------------------------------------
# differential: the JAX PagedCache and the port's, op by op
# ---------------------------------------------------------------------------
L, KV, HD = 2, 1, 4                 # layers, kv heads, head dim
BS, P, ROWS, MAX_LEN = 4, 12, 3, 24
NBLK = MAX_LEN // BS
_JITS: dict = {}                    # one fixed layout: executables reusable


def _hashes(content) -> list[bytes]:
    prev = hashlib.blake2b(b"seed", digest_size=16).digest()
    out = []
    for c in content:
        prev = hashlib.blake2b(prev + bytes([c]), digest_size=16).digest()
        out.append(prev)
    return out


def _pair(prefix_cache: bool, kv_cache_dtype: str = "model"):
    int8 = kv_cache_dtype == "int8"
    dt = jnp.int8 if int8 else jnp.float32
    stack = {"table": jnp.full((L, ROWS, NBLK), P, jnp.int32),
             "k_pages": jnp.zeros((L, P + 1, BS, KV, HD), dt),
             "v_pages": jnp.zeros((L, P + 1, BS, KV, HD), dt)}
    if int8:
        stack["k_scale_pages"] = jnp.zeros((L, P + 1, BS, KV), jnp.float32)
        stack["v_scale_pages"] = jnp.zeros((L, P + 1, BS, KV), jnp.float32)
    jc = JaxPagedCache({"stack": stack}, ROWS, JaxLayout(BS, P), MAX_LEN,
                       {"stack": None}, _JITS, prefix_cache=prefix_cache)
    layout = PagedLayout(BS, P)
    table = new_table(ROWS, MAX_LEN, layout, torch.device("cpu"))
    cfg = type("Cfg", (), {"n_kv_heads": KV, "head_dim": HD,
                           "kv_cache_dtype": kv_cache_dtype})
    ttree = [init_paged_attn_cache(cfg, table, layout, torch.float32)
             for _ in range(L)]
    return jc, PagedCache(ttree, ROWS, layout, MAX_LEN,
                          prefix_cache=prefix_cache)


def _assert_same(jc, tc):
    assert tc._blocks == jc._blocks
    assert tc._tokens == jc._tokens
    assert tc._pending == jc._pending
    assert tc.allocator._ref == jc.allocator._ref
    assert tc.allocator._free == jc.allocator._free
    assert list(tc._lru) == list(jc._lru)
    assert tc._hash_to_block == jc._hash_to_block
    g = jc.tree["stack"]
    for layer in range(L):
        np.testing.assert_array_equal(tc.tree[layer]["table"].numpy(),
                                      np.asarray(g["table"][layer]))
        assert set(tc.tree[layer]) == set(g)
        for name in set(g) - {"table"}:
            np.testing.assert_array_equal(
                tc.tree[layer][name][:P].numpy(),
                np.asarray(g[name][layer, :P]))


def _src(rng, W, int8):
    """A random dense prefill mini-cache (L, 1, W, ...) per leaf."""
    if not int8:
        return {n: rng.standard_normal((L, 1, W, KV, HD)).astype(np.float32)
                for n in ("k", "v")}
    src = {n: rng.integers(-127, 128, (L, 1, W, KV, HD)).astype(np.int8)
           for n in ("k", "v")}
    src.update({n: rng.random((L, 1, W, KV)).astype(np.float32)
                for n in ("k_scale", "v_scale")})
    return src


def _differential(seed, prefix_cache, kv_cache_dtype="model"):
    rng = np.random.default_rng(seed)
    int8 = kv_cache_dtype == "int8"
    jc, tc = _pair(prefix_cache, kv_cache_dtype)
    chains: dict[int, list] = {}
    for _ in range(40):
        op = rng.choice(["alloc", "alloc", "insert", "append", "free",
                         "flush", "register"])
        row = int(rng.integers(ROWS))
        live = bool(jc._blocks[row]) and row not in jc._pending
        if op == "alloc" and not jc._blocks[row] and row not in jc._pending:
            content = [int(c) for c in rng.integers(0, 2,
                                                    int(rng.integers(1, 4)))]
            # may end inside the last hit block: a later append forks it
            n_tokens = len(content) * BS + int(rng.integers(1 - BS, 3))
            chains[row] = _hashes(content)
            ok = jc.alloc(row, n_tokens, block_hashes=chains[row])
            assert tc.alloc(row, n_tokens, block_hashes=chains[row]) == ok
        elif op == "insert" and live:
            W = int(rng.choice([BS, 2 * BS]))
            offset = jc.hit_tokens(row)
            src = _src(rng, W, int8)
            jc.insert({"stack": {n: jnp.asarray(a) for n, a in src.items()}},
                      [row], offset=offset)
            tc.insert([{n: torch.from_numpy(a[i]) for n, a in src.items()}
                       for i in range(L)], [row], offset=offset)
        elif op == "append" and live:
            n = int(rng.integers(1, 6))
            assert tc.append(row, n) == jc.append(row, n)
        elif op == "free":
            jc.free(row)
            tc.free(row)
        elif op == "flush":
            jc.flush()
            tc.flush()
        elif op == "register" and live and row in chains:
            jc.register_prefix(row, chains[row])
            tc.register_prefix(row, chains[row])
        _assert_same(jc, tc)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("prefix_cache", [True, False])
def test_paged_cache_matches_jax_op_by_op(seed, prefix_cache):
    _differential(seed, prefix_cache)


@pytest.mark.parametrize("seed", range(3))
def test_int8_paged_cache_matches_jax_op_by_op(seed):
    """The same op sequence over int8 pages and their scale pages (the
    engine shares no int8 prefix, but the cache itself still indexes
    and forks them when asked)."""
    _differential(seed, True, "int8")


def test_gather_prefix_matches_jax():
    jc, tc = _pair(True)
    rng = np.random.default_rng(7)
    for row in range(2):
        assert jc.alloc(row, 3 * BS) and tc.alloc(row, 3 * BS)
        k = rng.standard_normal((L, 1, 3 * BS, KV, HD)).astype(np.float32)
        jc.insert({"stack": {"k": jnp.asarray(k), "v": jnp.asarray(-k)}},
                  [row])
        tc.insert([{"k": torch.from_numpy(k[i]),
                    "v": torch.from_numpy(-k[i])} for i in range(L)], [row])
    want = jc.gather_prefix([1, 0], 2 * BS + 1)["stack"]
    got = tc.gather_prefix([1, 0], 2 * BS + 1)
    for layer in range(L):
        for name in ("k", "v"):
            assert got[layer][name].shape == (2, 2 * BS + 1, KV, HD)
            np.testing.assert_array_equal(got[layer][name].numpy(),
                                          np.asarray(want[name][layer]))


def test_insert_past_the_table_lands_on_scratch():
    """A bucket-padded source running past the last logical block writes
    the overflow to the scratch page, never to a live block (a tensor
    index would raise or wrap there)."""
    _, tc = _pair(False)
    assert tc.alloc(0, MAX_LEN)
    src = [{"k": torch.full((1, 2 * BS, KV, HD), float(i + 1)),
            "v": torch.full((1, 2 * BS, KV, HD), float(i + 1))}
           for i in range(L)]
    tc.insert(src, [0], offset=MAX_LEN - BS)   # BS positions past the end
    last = tc._blocks[0][-1]
    for i in range(L):
        assert bool((tc.tree[i]["k_pages"][last] == i + 1).all())
        assert bool((tc.tree[i]["k_pages"][P] == i + 1).all())
        others = [b for b in range(P) if b != last]
        assert bool((tc.tree[i]["k_pages"][others] == 0).all())


def test_cow_fork_copies_k_and_v_pages_of_every_layer():
    _, tc = _pair(True)
    chain = _hashes([1, 2])
    assert tc.alloc(0, 2 * BS, block_hashes=chain)
    for i in range(L):                  # distinct contents per layer/page
        tc.tree[i]["k_pages"][:P] = torch.arange(P, dtype=torch.float32)[
            :, None, None, None] + 100 * i
        tc.tree[i]["v_pages"][:P] = -tc.tree[i]["k_pages"][:P]
    tc.insert([{"k": tc.tree[i]["k_pages"][tc._blocks[0]].reshape(
        1, 2 * BS, KV, HD), "v": tc.tree[i]["v_pages"][tc._blocks[0]]
        .reshape(1, 2 * BS, KV, HD)} for i in range(L)], [0])
    tc.register_prefix(0, chain)
    assert tc.alloc(1, 2 * BS - 2, block_hashes=chain)   # shares both
    shared = tc._blocks[1][1]
    assert shared == tc._blocks[0][1] and tc.allocator.ref(shared) == 3
    tc.insert([{"k": torch.zeros(1, 0, KV, HD),
                "v": torch.zeros(1, 0, KV, HD)}] * L, [1], offset=BS)
    assert tc.append(1, 1)            # position 2*BS-2 is in the shared block
    new = tc._blocks[1][1]
    assert new != shared and tc.allocator.ref(new) == 1
    assert tc.allocator.ref(shared) == 2
    assert int(tc._table[1, 1]) == new and int(tc._table[0, 1]) == shared
    for i in range(L):
        for name in ("k_pages", "v_pages"):
            pages = tc.tree[i][name]
            assert torch.equal(pages[new], pages[shared])
            assert bool((pages[new] != 0).any())


def test_cow_fork_and_gather_reach_int8_scale_pages_on_the_page_axis():
    """Scale pages are (P+1, bs, Hkv): one trailing axis fewer than the
    code pages. The fork copies them page for page, and gather_prefix
    reads them through the table, in every layer."""
    _, tc = _pair(True, "int8")
    chain = _hashes([3, 4])
    assert tc.alloc(0, 2 * BS, block_hashes=chain)
    for i in range(L):              # distinct contents per layer and page
        g = tc.tree[i]
        page_ids = torch.arange(P + 1, dtype=torch.float32)
        g["k_scale_pages"][:] = page_ids[:, None, None] + 100 * i
        g["v_scale_pages"][:] = -g["k_scale_pages"]
        g["k_pages"][:] = (torch.arange(P + 1) % 100).to(torch.int8)[
            :, None, None, None]
    tc.insert([{n: tc.tree[i][f"{n}_pages"][tc._blocks[0]].reshape(
        1, 2 * BS, *tc.tree[i][f"{n}_pages"].shape[2:])
        for n in ("k", "v", "k_scale", "v_scale")} for i in range(L)], [0])
    tc.register_prefix(0, chain)
    assert tc.alloc(1, 2 * BS - 2, block_hashes=chain)   # shares both
    shared = tc._blocks[1][1]
    got = tc.gather_prefix([1], 2 * BS - 2)
    for i in range(L):
        assert set(got[i]) == {"k", "v", "k_scale", "v_scale"}
        assert got[i]["k_scale"].shape == (1, 2 * BS - 2, KV)
        want = (torch.tensor(tc._blocks[1], dtype=torch.float32)
                .repeat_interleave(BS)[:2 * BS - 2] + 100 * i)
        assert torch.equal(got[i]["k_scale"][0, :, 0], want)
        assert torch.equal(got[i]["v_scale"][0, :, 0], -want)
    tc.insert([{n: torch.zeros(1, 0, *tc.tree[i][f"{n}_pages"].shape[2:],
                               dtype=tc.tree[i][f"{n}_pages"].dtype)
                for n in ("k", "v", "k_scale", "v_scale")}
               for i in range(L)], [1], offset=BS)
    assert tc.append(1, 1)            # position 2*BS-2 is in the shared block
    new = tc._blocks[1][1]
    assert new != shared
    for i in range(L):
        for name in ("k_pages", "v_pages", "k_scale_pages",
                     "v_scale_pages"):
            pages = tc.tree[i][name]
            assert torch.equal(pages[new], pages[shared]), (i, name)
        assert float(tc.tree[i]["k_scale_pages"][new, 0, 0]) \
            == shared + 100 * i


R, DR = 8, 4                        # latent rank and rope width


def _mla_cache():
    layout = PagedLayout(BS, P)
    table = new_table(ROWS, MAX_LEN, layout, torch.device("cpu"))
    cfg = type("Cfg", (), {"kv_lora_rank": R, "qk_rope_head_dim": DR})
    tree = [init_paged_mla_cache(cfg, table, layout, torch.float32)
            for _ in range(L)]
    return PagedCache(tree, ROWS, layout, MAX_LEN, prefix_cache=True)


def test_cow_fork_copies_mla_latent_pages_on_the_page_axis():
    """Latent pages are (P+1, bs, r) and rope-key pages (P+1, bs, dr): the
    fork copies every layer's pages of both page for page, and nothing
    else."""
    tc = _mla_cache()
    chain = _hashes([5, 6])
    assert tc.alloc(0, 2 * BS, block_hashes=chain)
    for i in range(L):
        g = tc.tree[i]
        page_ids = torch.arange(P + 1, dtype=torch.float32)[:, None, None]
        g["ckv_pages"][:] = page_ids + 100 * i + torch.arange(R)
        g["k_rope_pages"][:] = -(page_ids + 100 * i + torch.arange(DR))
    tc.register_prefix(0, chain)
    assert tc.alloc(1, 2 * BS - 2, block_hashes=chain)   # shares both
    shared = tc._blocks[1][1]
    before = [{n: t.clone() for n, t in g.items()} for g in tc.tree]
    tc.insert([{"ckv": torch.zeros(1, 0, R), "k_rope": torch.zeros(1, 0, DR)}
               for _ in range(L)], [1], offset=BS)
    assert tc.append(1, 1)            # position 2*BS-2 is in the shared block
    new = tc._blocks[1][1]
    assert new != shared and int(tc._table[1, 1]) == new
    for i in range(L):
        for name in ("ckv_pages", "k_rope_pages"):
            pages, old = tc.tree[i][name], before[i][name]
            assert torch.equal(pages[new], old[shared]), (i, name)
            others = [b for b in range(P + 1) if b != new]
            assert torch.equal(pages[others], old[others]), (i, name)


def test_gather_and_insert_reach_mla_pages_through_the_table():
    """``insert`` scatters a dense latent mini-cache into the row's pages
    and ``gather_prefix`` reads the same positions back, per layer."""
    tc = _mla_cache()
    rng = np.random.default_rng(11)
    assert tc.alloc(2, 3 * BS - 1)
    src = [{"ckv": torch.from_numpy(rng.standard_normal(
                (1, 3 * BS, R)).astype(np.float32)),
            "k_rope": torch.from_numpy(rng.standard_normal(
                (1, 3 * BS, DR)).astype(np.float32))} for _ in range(L)]
    tc.insert(src, [2])
    got = tc.gather_prefix([2], 2 * BS + 3)
    for i in range(L):
        assert set(got[i]) == {"ckv", "k_rope"}
        for name in ("ckv", "k_rope"):
            assert torch.equal(got[i][name], src[i][name][:, :2 * BS + 3])
        blocks = tc._blocks[2]
        assert torch.equal(tc.tree[i]["ckv_pages"][blocks[1]],
                           src[i]["ckv"][0, BS:2 * BS])
