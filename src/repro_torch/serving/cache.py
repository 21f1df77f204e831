"""The engine's caches: dense slot rows or paged blocks.

A port of ``repro.serving.cache``: the attention page pairs and, for an
int8 cache, their scale pages, or an MLA layer's latent and rope-key
pages.

* ``DenseCache`` — one private ``(max_len, ...)`` row per slot. A row is
  the reservation, so there is nothing to allocate; ``insert`` copies
  prefill rows into their slots in place.
* ``PagedCache`` — a shared pool of ``max_blocks`` physical pages plus a
  per-row block table (``models/cache.py``). Admission reserves
  ``ceil(tokens / block_size)`` blocks per request, so in-flight
  concurrency is bounded by the block budget, not by ``n_slots``. Layer
  groups that do not page (an SSM model's state rows) stay dense rows.

Both own the HOST-side accounting; the device tensors are the model's
cache tree (``tree``), which the paged cache updates in place on the
caller's CUDA stream where JAX ran jitted, donated tree transforms.
Paged invariants, as in JAX:

* every table entry outside a row's live reservation points at the
  SCRATCH page (index ``max_blocks``), so lockstep decode writes for idle
  rows land in the sink instead of a live block;
* ``free`` defers: freed rows park in a pending list, and ``flush`` points
  their table rows at scratch BEFORE the blocks return to the allocator,
  so a finished row can never write into a block admission just handed
  to another sequence.

Prefix sharing (``prefix_cache=True``): full prompt blocks are indexed by
content hash; admission maps a request's leading blocks onto hits, so
several rows' tables point at the SAME physical page and only the
residual suffix runs prefill. ``BlockAllocator`` is refcounted; the cache
holds its own reference on every indexed block (so a hit survives its
row), blocks whose only reference is the cache's sit in an LRU that
admission evicts from before refusing, and a write into a block with
refcount > 1 forks it copy-on-write (``append``/``_cow_fork``).
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from repro_torch.models.cache import PagedLayout, groups, is_paged_group


class BlockAllocator:
    """Refcounted free list over ``n_blocks`` physical page indices.
    ``alloc`` is all-or-nothing (None when short) and hands out blocks at
    refcount 1, popping the free list from its end as JAX does, so both
    hand out the same block numbers for the same calls; ``share`` adds a
    reference to live blocks; ``release`` drops one per block and returns
    those that reached zero (rejecting foreign indices and underflows);
    ``free`` is ``release`` without the return value."""

    def __init__(self, n_blocks: int):
        self.n_blocks = n_blocks
        self._free: list[int] = list(range(n_blocks))
        self._ref: dict[int, int] = {}

    @property
    def n_free(self) -> int:
        return len(self._free)

    def ref(self, block: int) -> int:
        """Current reference count (0 for free or foreign blocks)."""
        return self._ref.get(block, 0)

    def alloc(self, n: int) -> list[int] | None:
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        blocks = [self._free.pop() for _ in range(n)]
        for b in blocks:
            self._ref[b] = 1
        return blocks

    def share(self, blocks) -> None:
        """Add one reference to each of ``blocks`` (all must be live)."""
        for b in blocks:
            if b not in self._ref:
                raise ValueError(f"share of unallocated block {b}")
        for b in blocks:
            self._ref[b] += 1

    def release(self, blocks) -> list[int]:
        """Drop one reference per block; blocks reaching zero return to
        the free list and are returned."""
        for b in blocks:
            if b not in self._ref:
                raise ValueError(f"free of unallocated block {b}")
        freed = []
        for b in blocks:
            self._ref[b] -= 1
            if self._ref[b] == 0:
                del self._ref[b]
                self._free.append(b)
                freed.append(b)
        return freed

    def free(self, blocks) -> None:
        self.release(blocks)


class DenseCache:
    """Row-per-slot cache over a model's per-layer ``{"k", "v"}`` tensors
    of shape (n_rows, max_len, Hkv, hd), plus ``{"k_scale", "v_scale"}``
    (n_rows, max_len, Hkv) for an int8 cache, an MLA layer's ``{"ckv",
    "k_rope"}`` latent rows, an SSM model's ``{"conv", "state"}`` rows,
    or a whisper layer's ``"self"`` group beside its ``"mem_k"`` /
    ``"mem_v"`` rows; the row is axis 0 of every leaf."""

    def __init__(self, tree: list, n_rows: int):
        self.tree = tree
        self.n_rows = n_rows

    def free(self, row: int) -> None:
        """A row is its own reservation: nothing to release."""

    def insert(self, src_cache: list, rows: list[int],
               offset: int = 0) -> None:
        """Copy whole prefill rows (one per admitted request, same layout)
        into the engine cache at ``rows``, in place: every leaf of a
        layer's group, so an int8 cache's scales go with its codes."""
        if offset:
            raise ValueError("DenseCache rows always start at position 0")
        dst_groups = groups(self.tree)
        leaf = next(iter(dst_groups[0].values()))
        idx = torch.as_tensor(rows, dtype=torch.long, device=leaf.device)
        for dst, src in zip(dst_groups, groups(src_cache)):
            for name, t in dst.items():
                t.index_copy_(0, idx, src[name].to(t.dtype))


# (pages key, dense prefill-cache key) pairs a paged group may hold: the
# scale pairs only in an int8 cache, the latent pairs only in an MLA one
_PAGE_PAIRS = (("k_pages", "k"), ("v_pages", "v"),
               ("k_scale_pages", "k_scale"), ("v_scale_pages", "v_scale"),
               ("ckv_pages", "ckv"), ("k_rope_pages", "k_rope"))


def _pairs(group: dict) -> list[tuple[str, str]]:
    """The page pairs ``group`` holds."""
    return [(dk, sk) for dk, sk in _PAGE_PAIRS if dk in group]


class PagedCache:
    """Block-table cache. Host state: a refcounted allocator over the
    shared physical pages (one logical block spans every layer), per-row
    block lists, and — with ``prefix_cache`` — a content-hash index over
    full prompt blocks plus an LRU of cache-only residents. ``tree`` is
    the model's paged cache (a list of per-layer groups sharing one
    table); an empty list keeps everything on the host. An SSM model's
    tree holds no paged group, only its dense conv and state rows, as in
    JAX: there is no table to write or scrub, and the allocator's blocks
    still bound how many sequences are resident. A whisper layer's self
    attention group pages like any other; its memory rows stay dense
    (``models.cache.groups`` splits the layer)."""

    def __init__(self, tree: list, n_rows: int, layout: PagedLayout,
                 max_len: int, prefix_cache: bool = False):
        self.tree = tree
        self.n_rows = n_rows
        self.layout = layout
        self.max_len = max_len
        self.allocator = BlockAllocator(layout.max_blocks)
        self._blocks: list[list[int]] = [[] for _ in range(n_rows)]
        self._tokens: list[int] = [0] * n_rows
        self._pending: list[int] = []          # rows freed, not yet scrubbed
        self._groups = [g for g in groups(tree) if is_paged_group(g)]
        self.prefix_cache = prefix_cache
        # content-hash index over full prompt blocks (both directions),
        # and the LRU of blocks whose ONLY reference is the cache's own
        # (oldest first: eviction order under admission pressure)
        self._hash_to_block: dict[bytes, int] = {}
        self._block_hash: dict[int, bytes] = {}
        self._lru: OrderedDict[int, None] = OrderedDict()

    # -- accounting ----------------------------------------------------
    @property
    def n_live_blocks(self) -> int:
        """Distinct blocks held by rows (pending ones included until
        ``flush``) or by the prefix index; ``allocator.n_free +
        n_live_blocks == max_blocks`` at every point."""
        held = {b for blocks in self._blocks for b in blocks}
        held.update(self._block_hash)
        return len(held)

    def _cap(self, n_tokens: int) -> int:
        return min(n_tokens, self.max_len)

    def can_admit(self, n_tokens: int) -> bool:
        """Could a ``n_tokens`` reservation be met once every reclaimable
        block (deferred frees, evictable LRU residents) is counted?"""
        pending = set(self._pending)
        held = {b for row, blocks in enumerate(self._blocks)
                if blocks and row not in pending
                for b in blocks}
        return (self.layout.max_blocks - len(held)
                >= self.layout.n_blocks(self._cap(n_tokens)))

    # -- prefix index ----------------------------------------------------
    def peek_hit_blocks(self, block_hashes) -> list[int]:
        """Longest indexed chain of leading prompt-block hashes (a pure
        lookup)."""
        hits: list[int] = []
        for h in block_hashes:
            b = self._hash_to_block.get(h)
            if b is None:
                break
            hits.append(b)
        return hits

    def register_prefix(self, row: int, block_hashes) -> None:
        """Index ``row``'s leading full prompt blocks by content hash,
        taking the cache's own reference on each newly indexed block;
        hashes or blocks already indexed are skipped."""
        if not self.prefix_cache:
            return
        blocks = self._blocks[row]
        for i, h in enumerate(block_hashes):
            if i >= len(blocks):
                break
            b = blocks[i]
            if h in self._hash_to_block or b in self._block_hash:
                continue
            self.allocator.share([b])
            self._hash_to_block[h] = b
            self._block_hash[b] = h

    def _evict(self, block: int) -> None:
        """Drop a cache-only resident: unindex it and release the cache's
        reference (no live table points at it)."""
        self._lru.pop(block)
        h = self._block_hash.pop(block)
        del self._hash_to_block[h]
        self.allocator.release([block])

    def _reserve(self, n: int, protect=()) -> bool:
        """Ensure ``n`` free blocks, evicting LRU residents (oldest first,
        never one in ``protect``) before giving up."""
        while self.allocator.n_free < n:
            victim = next((b for b in self._lru if b not in protect), None)
            if victim is None:
                return False
            self._evict(victim)
        return True

    # -- reservations ----------------------------------------------------
    def alloc(self, row: int, n_tokens: int, block_hashes=()) -> bool:
        """Reserve blocks covering ``n_tokens`` positions for ``row``. With
        ``block_hashes`` the indexed prefix maps onto existing pages (the
        row shares them) and only the rest draws fresh blocks. The device
        table is written by ``insert``."""
        if self._blocks[row] or row in self._pending:
            raise ValueError(f"row {row} already holds a reservation")
        total = self.layout.n_blocks(self._cap(n_tokens))
        hits = (self.peek_hit_blocks(block_hashes)[:total]
                if self.prefix_cache else [])
        if not self._reserve(total - len(hits), protect=set(hits)):
            return False
        fresh = self.allocator.alloc(total - len(hits))
        if fresh is None:
            return False
        if hits:
            self.allocator.share(hits)
            for b in hits:
                self._lru.pop(b, None)     # row-referenced: not evictable
        self._blocks[row] = hits + fresh
        self._tokens[row] = self._cap(n_tokens)
        return True

    def append(self, row: int, n_tokens: int = 1) -> bool:
        """Extend ``row``'s reservation by ``n_tokens`` positions, forking
        any shared block the new positions land in first."""
        old = self._tokens[row]
        new_total = old + n_tokens
        if new_total > self.max_len:
            return False
        bs = self.layout.block_size
        for idx in range(old // bs,
                         min((new_total - 1) // bs + 1,
                             len(self._blocks[row]))):
            if (self.allocator.ref(self._blocks[row][idx]) > 1
                    and not self._cow_fork(row, idx)):
                return False
        need = (self.layout.n_blocks(new_total)
                - self.layout.n_blocks(old))
        if need > 0:
            if not self._reserve(need, protect=set(self._blocks[row])):
                return False
            blocks = self.allocator.alloc(need)
            if blocks is None:
                return False
            start = len(self._blocks[row])
            self._blocks[row].extend(blocks)
            self._write_table(row, start, blocks)
        self._tokens[row] = new_total
        return True

    def _cow_fork(self, row: int, idx: int) -> bool:
        """Give ``row`` a private copy of its shared logical block
        ``idx``: fresh block, page copy in every layer, table repoint,
        then drop the row's reference on the original."""
        old = self._blocks[row][idx]
        if not self._reserve(1, protect=set(self._blocks[row])):
            return False
        fresh = self.allocator.alloc(1)
        if fresh is None:
            return False
        new = fresh[0]
        for g in self._groups:
            for dk, _ in _pairs(g):
                g[dk][new].copy_(g[dk][old])
        self._write_table(row, idx, [new])
        self._blocks[row][idx] = new
        self.allocator.release([old])
        if old in self._block_hash and self.allocator.ref(old) == 1:
            self._lru[old] = None          # cache-only again: evictable
        return True

    def free(self, row: int) -> None:
        """Release ``row``'s reservation at the next ``flush``; idempotent,
        since two release paths may race on one row."""
        if not self._blocks[row] or row in self._pending:
            return
        self._pending.append(row)

    def flush(self) -> None:
        """Point pending rows' tables at scratch, then return their
        blocks (indexed blocks whose last reference is the cache's join
        the LRU)."""
        if not self._pending:
            return
        rows, self._pending = self._pending, []
        if self._groups:
            self._table[torch.as_tensor(rows, dtype=torch.long,
                                        device=self._table.device)] = \
                self.layout.scratch_page
        for row in rows:
            self.allocator.release(self._blocks[row])
            for b in self._blocks[row]:
                if b in self._block_hash and self.allocator.ref(b) == 1:
                    self._lru[b] = None
                    self._lru.move_to_end(b)
            self._blocks[row] = []
            self._tokens[row] = 0

    # -- device tensors ----------------------------------------------------
    @property
    def _table(self) -> torch.Tensor:
        """The (n_rows, nblk) block table every layer shares."""
        return self._groups[0]["table"]

    def _table_rows(self, rows: list[int]) -> np.ndarray:
        nblk = self.max_len // self.layout.block_size
        out = np.full((len(rows), nblk), self.layout.scratch_page, np.int32)
        for j, row in enumerate(rows):
            blocks = self._blocks[row]
            out[j, :len(blocks)] = blocks
        return out

    def _write_table(self, row: int, start: int, blocks: list[int]) -> None:
        """Point logical blocks [start, start+len) of ``row`` at
        ``blocks`` on the device."""
        if self._groups:
            self._table[row, start:start + len(blocks)] = torch.as_tensor(
                blocks, dtype=torch.int32, device=self._table.device)

    def gather_prefix(self, rows: list[int], n_tokens: int) -> list[dict]:
        """The first ``n_tokens`` cached positions of ``rows``, read out of
        the pages as one dense ``{"k", "v"}`` (len(rows), n_tokens, Hkv,
        hd) per layer (plus ``"k_scale"``/``"v_scale"`` from int8 pages;
        ``{"ckv", "k_rope"}`` from latent pages):
        the context a suffix prefill attends over. Call it before
        ``insert`` writes these rows' tables."""
        dev = self._table.device
        table = torch.from_numpy(self._table_rows(rows)).to(dev).long()
        pos = torch.arange(n_tokens, device=dev)
        page = table[:, pos // self.layout.block_size]      # (n, n_tokens)
        off = torch.remainder(pos, self.layout.block_size)
        return [{sk: g[dk][page, off] for dk, sk in _pairs(g)}
                for g in self._groups]

    def insert(self, src_cache: list, rows: list[int],
               offset: int = 0) -> None:
        """Write each row's table, then scatter the dense prefill
        mini-cache (one row per admitted request, width W) into the pages:
        position ``offset + i`` of a row lands at ``(table[p // bs],
        p % bs)``. Positions past the row's reservation hit the scratch
        page, and so do positions past the table (an explicit clamp: a
        tensor index there would raise or wrap). A layer group that is
        not paged (an SSM model's conv tails and states, a whisper layer's
        memory rows) takes its rows whole, as ``DenseCache.insert``
        copies them, so an admission overwrites whatever a freed row's
        lockstep decode steps left there and a freed row needs no
        reset."""
        pairs = list(zip(groups(self.tree), groups(src_cache)))
        if self._groups:
            self._scatter_pages(pairs, rows, offset)
        dense = [(g, src) for g, src in pairs if not is_paged_group(g)]
        if dense:
            leaf = next(iter(dense[0][0].values()))
            idx = torch.as_tensor(rows, dtype=torch.long, device=leaf.device)
            for g, src in dense:
                for name, t in g.items():
                    t.index_copy_(0, idx, src[name].to(t.dtype))

    def _scatter_pages(self, pairs: list, rows: list[int],
                       offset: int) -> None:
        dev = self._table.device
        bs, scratch = self.layout.block_size, self.layout.scratch_page
        host = self._table_rows(rows)
        table = torch.from_numpy(host).to(dev)
        self._table[torch.as_tensor(rows, dtype=torch.long,
                                    device=dev)] = table
        nblk = host.shape[1]
        paged = [(g, src) for g, src in pairs if is_paged_group(g)]
        W = paged[0][1][_pairs(paged[0][0])[0][1]].shape[1]
        pos = torch.arange(W, device=dev) + offset
        blk = pos // bs
        page = torch.where(blk[None, :] < nblk,
                           table.long()[:, blk.clamp(max=nblk - 1)],
                           scratch)                            # (n, W)
        off = torch.remainder(pos, bs)
        for g, src in paged:
            for dk, sk in _pairs(g):
                g[dk][page, off] = src[sk].to(g[dk].dtype)
