"""Paged KV cache: device page pools + host-side refcounted allocator
and shared-prefix page trie.

Counterpart of ``paddle_tpu/serving/paged_cache.py``, with its own copy
of the host bookkeeping (the port imports nothing of the JAX package):
K/V for all in-flight requests live in one pool of fixed-size token
pages per layer, ``(L, num_pages, page_size, nkv, hd)`` tensors on the
device, and each request holds an ordered block table of page ids.
Pages are refcounted; the :class:`PrefixCache` trie maps chains of full
prompt pages (plus one partial tail per chain) to the pages that already
hold their KV, and the first partial page of a shared span is copied on
write. Page id 0 is the trash page that inactive decode rows write to.

The allocator, trie and block tables are plain numpy, as in the JAX
package. Where JAX ran a donated jitted program to update the pools,
the port writes the pool tensors in place: a page move
(:func:`_pool_move`) is an ``index_select`` into a fresh tensor, then
an ``index_copy_``, so a move within one pool whose source and
destination ids overlap (:meth:`PagedKVCache.defrag`) reads every
source page before it writes one. The JAX package pads the id vectors
to a power of two to bound its compile count; the port compiles
nothing and moves exactly the pages asked for. The allocator's
``alloc`` and ``free`` are fault-injection sites (:mod:`.resilience`),
and the trie with its pages' KV bytes checkpoints and restores for a
drain (:meth:`PagedKVCache.checkpoint_prefix` / :meth:`PagedKVCache.
restore_prefix`).

A request's pages also leave the pool as a byte payload
(:meth:`PagedKVCache.export_request`, the prefill→decode handoff) and
come back (:meth:`PagedKVCache.import_request`), or move between two
engines' pools on the device (:meth:`PagedKVCache.
import_request_direct`). A payload holds each pool array's raw bytes
(``uint8``) with its dtype name and shape, the JAX package's
convention, so a bf16 pool round-trips through numpy, which has no
bf16.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..observability import hooks as _obs
from .resilience import fault_point, payload_checksums, verify_checksums

#: page id never handed out by the allocator — the write target for
#: inactive rows of the static-shape decode step
TRASH_PAGE = 0


def _pool_move(pool: Dict, src_ids: torch.Tensor, dst_ids: torch.Tensor,
               src_pool: Optional[Dict] = None):
    """Copy pages ``src_ids`` into pages ``dst_ids`` of every pool
    array, in place: each array's source pages are gathered into a
    fresh tensor (``index_select``) before any destination page is
    written (``index_copy_``), so ids that overlap within one pool are
    safe. ``src_pool`` (another cache's pool of the same geometry) moves
    pages ACROSS pools, its pages read-only."""
    src = pool if src_pool is None else src_pool
    for name, arr in pool.items():
        arr.index_copy_(1, dst_ids, src[name].index_select(1, src_ids))


def dtype_name(dtype) -> str:
    """A pool dtype as payload metadata names it: numpy's name, which is
    what the JAX package writes (``"bfloat16"``, ``"float32"``,
    ``"int8"``)."""
    return str(dtype).replace("torch.", "")


def raw_bytes(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor's bytes as a flat ``uint8`` numpy array that shares
    its memory (no copy)."""
    return t.contiguous().view(torch.uint8).reshape(-1).numpy()


def typed_tensor(raw: np.ndarray, meta: Dict) -> torch.Tensor:
    """The CPU tensor a payload array's raw bytes hold, typed and shaped
    by its ``{"shape", "dtype"}`` metadata (a bf16 array without
    numpy's help; the callers have checked the dtype name against the
    pool's). Copies only a read-only buffer."""
    raw = np.require(np.asarray(raw).reshape(-1).view(np.uint8),
                     requirements=("C", "W"))
    return torch.from_numpy(raw).view(getattr(torch, meta["dtype"])).reshape(
        meta["shape"])


class PoolExhausted(RuntimeError):
    """An allocation the free list cannot satisfy. Continuous batching
    treats it as back-pressure: the admission waits until running
    requests retire and recycle their pages."""


class BlockAllocator:
    """Host-side page allocator over the global pool, refcounted.

    Page ids start at ``reserved`` (default 1 — page 0 is the trash
    page). ``alloc`` hands out pages at refcount 1; ``share`` takes an
    additional reference on a live page; ``free`` drops one reference
    and recycles the page at zero, so ``allocs_total == frees_total``
    once everything is released."""

    def __init__(self, num_pages: int, reserved: int = 1):
        if num_pages <= reserved:
            raise ValueError(
                f"BlockAllocator: num_pages={num_pages} must exceed the "
                f"{reserved} reserved page(s)")
        self.num_pages = num_pages
        self.reserved = reserved
        # descending storage so list.pop() hands out ascending ids
        self._free: List[int] = list(range(num_pages - 1, reserved - 1, -1))
        self._refcount = np.zeros((num_pages,), np.int32)
        self.allocs_total = 0
        self.frees_total = 0
        self.shares_total = 0
        self.alloc_failures = 0
        self.defrags_total = 0
        self.peak_in_use = 0

    @property
    def num_usable(self) -> int:
        return self.num_pages - self.reserved

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_used(self) -> int:
        return self.num_usable - len(self._free)

    @property
    def shared_pages(self) -> int:
        return int((self._refcount > 1).sum())

    def refcount(self, page: int) -> int:
        return int(self._refcount[page])

    def utilization(self) -> float:
        total = self.num_usable
        return self.num_used / total if total else 0.0

    def fragmentation(self) -> float:
        """Fraction of free pages sitting BELOW the highest used page:
        holes a compaction would close. Shared pages count as used like
        any other live page."""
        if not self._free or self.num_used == 0:
            return 0.0
        free = set(self._free)
        top_used = max(i for i in range(self.reserved, self.num_pages)
                       if i not in free)
        holes = sum(1 for f in self._free if f < top_used)
        return holes / len(self._free)

    def alloc(self, n: int) -> List[int]:
        """Hand out ``n`` pages at refcount 1; raises
        :class:`PoolExhausted` (and counts the failure) when the free
        list is short."""
        if n < 0:
            raise ValueError(f"alloc of negative page count {n}")
        # resilience site: fires BEFORE any free-list mutation, so an
        # injected allocator fault leaves the books consistent (the
        # supervisor discards the whole pool on recovery regardless)
        fault_point("alloc")
        if n > len(self._free):
            self.alloc_failures += 1
            raise PoolExhausted(
                f"need {n} pages, {len(self._free)} free "
                f"(pool {self.num_pages}, {self.reserved} reserved)")
        got = [self._free.pop() for _ in range(n)]
        for p in got:
            self._refcount[p] = 1
        self.allocs_total += n
        self.peak_in_use = max(self.peak_in_use, self.num_used)
        return got

    def share(self, pages: Sequence[int]):
        for p in pages:
            if not (self.reserved <= p < self.num_pages):
                raise ValueError(f"share of out-of-range page {p}")
            if self._refcount[p] < 1:
                raise ValueError(f"share of free page {p}")
        for p in pages:
            self._refcount[p] += 1
        self.allocs_total += len(pages)
        self.shares_total += len(pages)

    def free(self, pages: Sequence[int]):
        """Drop one reference per entry; a page recycles into the free
        list when its count reaches zero. The whole call is validated
        before any state changes."""
        fault_point("free")
        drops: Dict[int, int] = {}
        for p in pages:
            if not (self.reserved <= p < self.num_pages):
                raise ValueError(f"free of out-of-range page {p}")
            drops[p] = drops.get(p, 0) + 1
        for p, n in drops.items():
            if n > self._refcount[p]:
                raise ValueError(f"double free of page {p}")
        recycled = []
        for p in pages:
            self._refcount[p] -= 1
            if self._refcount[p] == 0:
                recycled.append(p)
        self._free.extend(recycled)
        self._free.sort(reverse=True)
        self.frees_total += len(pages)

    def stats(self) -> Dict[str, float]:
        return {
            "num_pages": self.num_pages,
            "num_reserved": self.reserved,
            "num_usable": self.num_usable,
            "num_used": self.num_used,
            "num_free": self.num_free,
            "shared_pages": self.shared_pages,
            "utilization": self.utilization(),
            "fragmentation": self.fragmentation(),
            "allocs_total": self.allocs_total,
            "frees_total": self.frees_total,
            "shares_total": self.shares_total,
            "alloc_failures": self.alloc_failures,
            "defrags_total": self.defrags_total,
            "peak_in_use": self.peak_in_use,
        }


class _TrieNode:
    __slots__ = ("page", "children", "tail", "tick")

    def __init__(self, page: Optional[int] = None):
        self.page = page
        self.children: Dict[bytes, "_TrieNode"] = {}
        # (page_id, token array): ONE partial-page donor per chain, the
        # copy-on-write source
        self.tail: Optional[Tuple[int, np.ndarray]] = None
        self.tick = 0


class PrefixCache:
    """Hash-trie over FULL prompt pages (+ one partial tail per chain).

    A node at depth ``j`` keys the tokens of prompt page ``j`` given the
    pages before it and holds the pool page with that span's KV. The
    trie owns one allocator reference per held page; :meth:`evict`
    drops references LRU-first (tails, then leaves)."""

    def __init__(self, page_size: int):
        self.page_size = page_size
        self.root = _TrieNode()
        self._tick = 0
        self.evictions_total = 0

    def _bump(self, node: _TrieNode):
        self._tick += 1
        node.tick = self._tick

    def match(self, prompt: np.ndarray):
        """Longest shared span of ``prompt``: ``(full_page_ids, tail)``,
        ``tail`` ``(donor_page, rows)`` for a copy-on-write partial
        continuation or None. Capped at ``len(prompt) - 1`` tokens so at
        least one prompt token is forwarded."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        pg = self.page_size
        max_full = max(0, (prompt.size - 1) // pg)
        node, pages = self.root, []
        for j in range(max_full):
            child = node.children.get(
                prompt[j * pg:(j + 1) * pg].tobytes())
            if child is None:
                break
            node = child
            self._bump(node)
            pages.append(node.page)
        rem = prompt[len(pages) * pg:]
        limit = prompt.size - 1 - len(pages) * pg
        tail = None
        if rem.size == pg:
            # page-aligned span stopped by the cap: CoW all but the last
            # row of a matching full child
            child = node.children.get(rem.tobytes())
            if child is not None:
                self._bump(child)
                tail = (int(child.page), pg - 1)
        if tail is None and node.tail is not None:
            donor, ttok = node.tail
            m = min(ttok.size, rem.size, limit)
            if m > 0:
                eq = ttok[:m] == rem[:m]
                t = int(m if eq.all() else np.argmax(~eq))
                if t > 0:
                    self._bump(node)
                    tail = (int(donor), t)
        return pages, tail

    def register(self, prompt: np.ndarray, pages: Sequence[int],
                 allocator: BlockAllocator):
        """Insert ``prompt``'s full pages (and partial tail) into the
        trie, taking one reference per newly covered page."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        pg = self.page_size
        node = self.root
        for j in range(prompt.size // pg):
            key = prompt[j * pg:(j + 1) * pg].tobytes()
            child = node.children.get(key)
            if child is None:
                child = _TrieNode(page=int(pages[j]))
                allocator.share([child.page])
                node.children[key] = child
            node = child
            self._bump(node)
        rem = prompt.size % pg
        if rem and node.tail is None:
            k = prompt.size // pg
            node.tail = (int(pages[k]), prompt[k * pg:].copy())
            allocator.share([node.tail[0]])
            self._bump(node)

    def _candidates(self):
        """Evictable references: every tail, plus leaf nodes with no
        tail, each with its chain's tokens from the root (the host
        tier's demotion key)."""
        out = []
        stack = [(self.root, None, None, b"")]
        while stack:
            node, parent, key, path = stack.pop()
            if node.tail is not None:
                out.append((node.tick, 0, node, parent, key, True, path))
            elif parent is not None and not node.children:
                out.append((node.tick, 1, node, parent, key, False, path))
            for k, c in node.children.items():
                stack.append((c, node, k, path + k))
        return out

    def evict(self, allocator: BlockAllocator, need: int,
              on_evict=None) -> int:
        """Drop trie references LRU-first until ``need`` pages returned
        to the free list or nothing evictable remains; returns pages
        freed. ``on_evict(chain_tokens, page_id)`` fires for every FULL
        page before its reference drops (the host tier's demotion: the
        page's bytes are still live then); tails never fire it."""
        start = allocator.num_free
        progressed = True
        while allocator.num_free - start < need and progressed:
            cands = self._candidates()
            cands.sort(key=lambda c: (c[0], c[1]))
            progressed = False
            for _, _, node, parent, key, is_tail, path in cands:
                if is_tail:
                    allocator.free([node.tail[0]])
                    node.tail = None
                else:
                    if on_evict is not None:
                        on_evict(np.frombuffer(path, np.int32),
                                 int(node.page))
                    allocator.free([node.page])
                    del parent.children[key]
                self.evictions_total += 1
                progressed = True
                if allocator.num_free - start >= need:
                    break
        return allocator.num_free - start

    def drop_all(self, allocator: BlockAllocator) -> int:
        """Release every trie reference."""
        start = allocator.num_free
        self.evict(allocator, allocator.num_pages)
        return allocator.num_free - start

    def pages(self) -> List[int]:
        """Every page id the trie holds a reference on."""
        out = []
        stack = [self.root]
        while stack:
            node = stack.pop()
            if node.page is not None:
                out.append(node.page)
            if node.tail is not None:
                out.append(node.tail[0])
            stack.extend(node.children.values())
        return out

    def to_records(self) -> Dict:
        """Serialize the trie STRUCTURE for a drain checkpoint:
        ``nodes`` is a parent-before-child list of ``[parent_index,
        page_tokens, page_id]`` (parent ``-1`` = the root), ``tails`` a
        list of ``[node_index, tail_tokens, page_id]`` (node ``-1`` = a
        root tail). Page ids are the OLD pool's — :meth:`restore_records`
        remaps them into the restored pool. Pure host data, JSON-able,
        and equal to the JAX package's records for the same inserts."""
        nodes: List[list] = []
        tails: List[list] = []
        stack = [(self.root, -1)]
        while stack:
            node, idx = stack.pop()
            if node.tail is not None:
                tails.append([idx, node.tail[1].tolist(),
                              int(node.tail[0])])
            for key, child in node.children.items():
                nodes.append([idx,
                              np.frombuffer(key, np.int32).tolist(),
                              int(child.page)])
                stack.append((child, len(nodes) - 1))
        return {"nodes": nodes, "tails": tails}

    def restore_records(self, records: Dict, page_map: Dict[int, int],
                        allocator: BlockAllocator):
        """Rebuild the trie from :meth:`to_records` output under
        remapped page ids, taking ONE allocator reference per restored
        page reference (the ownership :meth:`register` establishes).
        Restores into an EMPTY trie only — merging two tries would
        double-count references."""
        if self.root.children or self.root.tail is not None:
            raise ValueError("restore_records: the trie is not empty")
        built: List[_TrieNode] = []
        for parent, tokens, page in records["nodes"]:
            node = _TrieNode(page=page_map[int(page)])
            allocator.share([node.page])
            owner = self.root if parent < 0 else built[parent]
            owner.children[
                np.asarray(tokens, np.int32).tobytes()] = node
            built.append(node)
        for idx, tokens, page in records["tails"]:
            owner = self.root if idx < 0 else built[idx]
            owner.tail = (page_map[int(page)],
                          np.asarray(tokens, np.int32))
            allocator.share([owner.tail[0]])

    def remap_pages(self, remap: np.ndarray):
        """Rewrite held page ids after a compaction moved pages."""
        stack = [self.root]
        while stack:
            node = stack.pop()
            if node.page is not None:
                node.page = int(remap[node.page])
            if node.tail is not None:
                node.tail = (int(remap[node.tail[0]]), node.tail[1])
            stack.extend(node.children.values())


class PagedKVCache:
    """Device page pools + per-slot block tables + the allocator.

    ``max_batch`` decode slots share one pool of ``num_pages`` pages of
    ``page_size`` tokens. Block tables, lengths and the active mask are
    host numpy; the pool tensors in ``self.pool`` (keys ``k``/``v``, plus
    ``ks``/``vs`` for the int8 tier) live on ``device`` and are written
    in place by the prefill and decode forwards. ``enable_prefix_cache``
    (default on) attaches the :class:`PrefixCache` trie; off, ``prefix``
    is None and admissions share nothing."""

    def __init__(self, cfg, max_batch: int, max_len: int,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 kv_dtype=None, enable_prefix_cache: bool = True,
                 device: DeviceLike = None):
        from ..models import generate as _gen
        if max_len % page_size:
            max_len = (max_len // page_size + 1) * page_size
        self.device = resolve_device(device)
        self.max_batch = max_batch
        self.max_len = max_len
        self.page_size = page_size
        self.pages_per_seq = max_len // page_size
        if num_pages is None:
            # worst case every slot runs a full-length request, +1 trash
            num_pages = 1 + max_batch * self.pages_per_seq
        self.pool = _gen.init_paged_cache(cfg, num_pages, page_size,
                                          kv_dtype=kv_dtype,
                                          device=self.device)
        self.kv_dtype = kv_dtype
        self.num_pages = num_pages
        self.allocator = BlockAllocator(num_pages)
        self.prefix = PrefixCache(page_size) if enable_prefix_cache else None
        self.cow_copies = 0
        self.direct_moves_total = 0
        #: host seconds of :meth:`_scatter_pages` by part: ``read`` (a
        #: payload array into a typed CPU tensor), ``pin`` (into pinned
        #: memory), ``copy`` (the upload and the scatter, queued)
        self.scatter_host_s = {"read": 0.0, "pin": 0.0, "copy": 0.0}
        # host tensors whose uploads may not have run yet, each with an
        # event recorded after its copy (:meth:`_hold`)
        self._held: List[Tuple] = []
        self.block_tables = np.full((max_batch, self.pages_per_seq),
                                    TRASH_PAGE, np.int32)
        self.lengths = np.zeros((max_batch,), np.int32)
        self.active = np.zeros((max_batch,), bool)
        self._slot_pages: List[List[int]] = [[] for _ in range(max_batch)]

    # ---- slot lifecycle (host) ----
    def pages_for(self, total_tokens: int) -> int:
        return -(-total_tokens // self.page_size)

    def ctx_cap_pages(self, n_pages: int) -> int:
        """Bucket a context page count UP to a power of two (capped at
        ``pages_per_seq``): the JAX engine's compile-key rule, kept so
        that the gathered-context widths — and with them the attention
        reduction widths — match it."""
        if n_pages <= 0:
            return 0
        p2 = 1
        while p2 < n_pages:
            p2 *= 2
        return min(p2, self.pages_per_seq)

    def _check_admit(self, slot: int, total_tokens: int) -> int:
        if self.active[slot]:
            raise ValueError(f"slot {slot} already active")
        n = self.pages_for(total_tokens)
        if n > self.pages_per_seq:
            raise ValueError(
                f"request of {total_tokens} tokens needs {n} pages; the "
                f"cache holds max_len={self.max_len} "
                f"({self.pages_per_seq} pages) per request")
        return n

    def _alloc_with_evict(self, n: int) -> List[int]:
        """Allocate ``n`` pages, reclaiming prefix-trie references under
        pool pressure (one failed admission counts one failure)."""
        try:
            return self.allocator.alloc(n)
        except PoolExhausted:
            if self.prefix is not None:
                self._evict_prefix(n - self.allocator.num_free)
            if n > self.allocator.num_free:
                raise
            return self.allocator.alloc(n)

    def _evict_prefix(self, need: int) -> int:
        """Reclaim ``need`` pages of prefix-trie references under pool
        pressure. The host tier (:class:`~.host_tier.TieredKVCache`)
        overrides this to DEMOTE each dropped full page's bytes to host
        RAM first; here they die and prefill again on the next miss."""
        return self.prefix.evict(self.allocator, need)

    def _install(self, slot: int, pages: List[int]) -> np.ndarray:
        self._slot_pages[slot] = pages
        self.block_tables[slot] = TRASH_PAGE
        self.block_tables[slot, :len(pages)] = pages
        self.active[slot] = True
        return self.block_tables[slot]

    def admit(self, slot: int, total_tokens: int) -> np.ndarray:
        """Reserve pages for ``total_tokens`` on ``slot`` (no prefix
        sharing); returns the slot's block-table row."""
        n = self._check_admit(slot, total_tokens)
        return self._install(slot, self._alloc_with_evict(n))

    def admit_prompt(self, slot: int, prompt,
                     total_tokens: int) -> Tuple[np.ndarray, int]:
        """Admit with prefix sharing: map the trie-matched span of
        ``prompt``'s pages into the slot's table, copy-on-write the
        matched rows of the first partial page, allocate the rest.
        Returns ``(block-table row, shared_tokens)``."""
        n = self._check_admit(slot, total_tokens)
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if total_tokens < prompt.size:
            raise ValueError(
                f"admit_prompt: total_tokens={total_tokens} is smaller "
                f"than the {prompt.size}-token prompt it must contain")
        if self.prefix is None or prompt.size == 0:
            return self._install(slot, self._alloc_with_evict(n)), 0
        shared, tail = self.prefix.match(prompt)
        # pin the matched pages FIRST: the eviction a fresh-page alloc
        # may trigger must not recycle the span about to be mapped
        self.allocator.share(shared)
        try:
            fresh = self._alloc_with_evict(n - len(shared))
        except PoolExhausted:
            if shared:
                self.allocator.free(shared)
            raise
        shared_tokens = len(shared) * self.page_size
        if tail is not None and fresh:
            donor, rows = tail
            self._cow_copy(donor, fresh[0], rows)
            shared_tokens += rows
            self.cow_copies += 1
        return self._install(slot, shared + fresh), shared_tokens

    def _cow_copy(self, src_page: int, dst_page: int, rows: int):
        """Copy the first ``rows`` token rows of ``src_page`` into
        ``dst_page`` for every pool array, in place."""
        for arr in self.pool.values():
            arr[:, dst_page, :rows] = arr[:, src_page, :rows]

    def register_prefix(self, slot: int, prompt):
        """Publish a fully prefilled prompt's pages into the trie."""
        if self.prefix is None:
            return
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0 or not self.active[slot]:
            return
        self.prefix.register(prompt, self._slot_pages[slot],
                             self.allocator)

    def release(self, slot: int):
        """Retire a request: drop its page references."""
        if self._slot_pages[slot]:
            self.allocator.free(self._slot_pages[slot])
        self._slot_pages[slot] = []
        self.block_tables[slot] = TRASH_PAGE
        self.lengths[slot] = 0
        self.active[slot] = False

    def evict_for_preempt(self, slot: int) -> int:
        """Preemption eviction: release ``slot``'s page references back
        to the pool and report how many pages actually reached the free
        list. Pages the prefix trie (or another table) still references
        survive under those references, and a later resume can map them
        straight back in. The slot's KV rows are not zeroed: freed pages
        carry finite garbage until their next tenant overwrites them.
        On the card a decode step still in flight for the evicted slot
        writes its row into a freed page; the next tenant's writes are
        queued after it on the same stream, so they land last."""
        if not self.active[slot]:
            raise ValueError(f"evict_for_preempt of inactive slot {slot}")
        before = self.allocator.num_free
        self.release(slot)
        return self.allocator.num_free - before

    def free_slots(self) -> List[int]:
        return [i for i in range(self.max_batch) if not self.active[i]]

    def pages_held(self, slot: int) -> List[int]:
        """The page ids ``slot``'s block table references (a copy)."""
        return list(self._slot_pages[slot])

    @property
    def kv_dtype_name(self) -> Optional[str]:
        """The KV tier as a drain checkpoint names it: ``"int8"``, or
        None for the model dtype (the JAX package's names)."""
        return None if self.kv_dtype is None else "int8"

    def page_payload_bytes(self, k: int) -> int:
        """Device bytes of ``k`` pages across every pool array."""
        return sum(int(np.prod(a.shape[2:])) * a.shape[0] * k
                   * a.element_size() for a in self.pool.values())

    # ---- drain/restore: prefix-trie persistence ----
    def checkpoint_prefix(self) -> Optional[Dict]:
        """Checkpoint the prefix-cache trie for an engine drain: the trie
        structure (:meth:`PrefixCache.to_records`) plus the KV BYTES of
        every page the trie references, gathered on the device and
        fetched to the host as numpy in one copy per pool array. A bf16
        pool's pages come as their uint16 bit patterns (numpy has no
        bf16). Returns None when the prefix cache is disabled or
        empty."""
        if self.prefix is None:
            return None
        ids = sorted(set(self.prefix.pages()))
        if not ids:
            return None
        sel = torch.as_tensor(ids, dtype=torch.long, device=self.device)
        arrays = {}
        for name, arr in self.pool.items():
            pages = arr.index_select(1, sel)
            if pages.dtype == torch.bfloat16:
                arrays[name] = (pages.view(torch.int16).cpu().numpy()
                                .view(np.uint16))
            else:
                arrays[name] = pages.cpu().numpy()
        return {"page_ids": [int(p) for p in ids],
                "records": self.prefix.to_records(),
                "arrays": arrays}

    def restore_prefix(self, ckpt: Dict) -> int:
        """Restore a :meth:`checkpoint_prefix` into THIS (fresh) cache:
        allocate pages, write the saved KV bytes into the pool at the
        remapped ids (:meth:`_scatter_pages`), and rebuild the trie so
        future admissions prefix-HIT the restored pages. The bootstrap
        allocation references are dropped once the trie holds its own,
        so the trie ends up owning exactly one reference per page, as
        :meth:`register_prefix` would leave it. Returns the number of
        pages restored."""
        if self.prefix is None:
            raise ValueError(
                "restore_prefix into a cache with prefix caching "
                "disabled (enable_prefix_cache=False)")
        old_ids = [int(p) for p in ckpt["page_ids"]]
        fresh = self.allocator.alloc(len(old_ids))
        page_map = dict(zip(old_ids, fresh))
        self._scatter_pages(ckpt["arrays"], fresh)
        self.prefix.restore_records(ckpt["records"], page_map,
                                    self.allocator)
        self.allocator.free(fresh)      # the trie owns the pages now
        return len(fresh)

    def _ids(self, ids: Sequence[int]) -> torch.Tensor:
        """Page ids as an int64 tensor on the pool's device, sent the
        way the engine's ``_up`` sends its inputs: through pinned memory
        with a non-blocking copy, so building it never waits for the
        card."""
        t = torch.from_numpy(np.asarray(ids, np.int64).reshape(-1))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _hold(self, tensors) -> None:
        """Keep host tensors alive until the uploads queued from them
        have run: an event is recorded after the copies, and entries
        whose events completed are let go. A tensor that aliases pinned
        memory PyTorch's caching host allocator does not know (a numpy
        view of a payload) gets no event of its own from ``copy_``;
        holding it keeps that memory from being freed, and reused by a
        host write, under a copy still in flight."""
        self._release_held()
        ev = torch.cuda.Event()
        ev.record()
        self._held.append((ev, tensors))

    def _release_held(self) -> None:
        """Let go of the held host tensors whose uploads have run, so
        that their pinned blocks go back to the caching host allocator
        before a gather asks it for more."""
        if self._held:
            self._held = [h for h in self._held if not h[0].query()]

    def _scatter_pages(self, arrays: Dict, dst: Sequence[int]):
        """Write per-array page payloads ``(L, k, page, ...)`` into the
        pool at page ids ``dst``: numpy arrays (uint16 into a bf16 pool
        are bit patterns, :meth:`checkpoint_prefix`) or typed CPU
        tensors. Each goes up through pinned memory with a non-blocking
        copy and lands with one in-place ``index_copy_``; nothing waits
        for the card. The host time of each part accumulates in
        ``scatter_host_s``."""
        idx = self._ids(dst)
        cuda = self.device.type == "cuda"
        acc = self.scatter_host_s
        for name, arr in self.pool.items():
            t0 = time.perf_counter()
            a = arrays[name]
            if isinstance(a, torch.Tensor):
                t = a if a.dtype == arr.dtype else a.to(arr.dtype)
            else:
                a = np.array(a, copy=True, order="C")
                if arr.dtype == torch.bfloat16 and a.dtype.itemsize == 2 \
                        and a.dtype.kind in "ui":
                    t = torch.from_numpy(a.view(np.int16)).view(
                        torch.bfloat16)
                else:
                    t = torch.from_numpy(a).to(arr.dtype)
            t1 = time.perf_counter()
            if cuda and not t.is_pinned():
                t = t.pin_memory()
            t2 = time.perf_counter()
            if cuda:
                src = t.to(self.device, non_blocking=True)
                self._hold(t)
            else:
                src = t
            arr.index_copy_(1, idx, src)
            acc["read"] += t1 - t0
            acc["pin"] += t2 - t1
            acc["copy"] += time.perf_counter() - t2

    def _fetch_pages(self, ids: Sequence[int]) -> Dict[str, torch.Tensor]:
        """The pages at ``ids`` of every pool array as typed CPU tensors
        ``(L, k, page, ...)``: one ``index_select`` on the device, then
        one copy into pinned host memory (PyTorch's caching host
        allocator) per array, waited for here."""
        self._release_held()
        idx = self._ids(ids)
        out = {}
        for name, arr in self.pool.items():
            g = arr.index_select(1, idx)
            if self.device.type == "cuda":
                h = torch.empty(g.shape, dtype=g.dtype, pin_memory=True)
                h.copy_(g, non_blocking=True)
                g = h
            out[name] = g
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return out

    def _move_pages(self, src_ids: Sequence[int], dst_ids: Sequence[int],
                    src_cache: Optional["PagedKVCache"] = None):
        """Copy pages ``src_ids`` (of this pool, or of ``src_cache``'s)
        into this pool's pages ``dst_ids`` on the device
        (:func:`_pool_move`): no host staging, nothing re-materialized,
        nothing waited for unless a timing sink is on."""
        t0 = _obs.generate_begin()
        src = self._ids(src_ids)
        dst = self._ids(dst_ids)
        _pool_move(self.pool, src, dst,
                   None if src_cache is None else src_cache.pool)
        self.direct_moves_total += 1
        _obs.serving_fused_latency("pool_move", t0,
                                   next(iter(self.pool.values())))

    def import_request_direct(self, slot: int,
                              src_cache: "PagedKVCache", src_slot: int,
                              total_tokens: int) -> np.ndarray:
        """The in-process fast path of the prefill→decode handoff: admit
        ``slot`` and copy the source slot's live pages straight from
        ``src_cache``'s pool into freshly allocated pages
        (:meth:`_move_pages`), instead of the :meth:`export_request` →
        :meth:`import_request` pair through host memory. Byte-identical
        to the host-staged handoff; geometry and dtype are validated as
        loudly. The source slot is read-only — the exporting engine owns
        it until its ``finish_handoff``."""
        if not src_cache.active[src_slot]:
            raise ValueError(
                f"import_request_direct: source slot {src_slot} is "
                f"inactive")
        length = int(src_cache.lengths[src_slot])
        if length <= 0:
            raise ValueError(
                f"import_request_direct: source slot {src_slot} has no "
                f"committed tokens — hand off only after prefill "
                f"completes")
        if src_cache.page_size != self.page_size:
            raise ValueError(
                f"import_request_direct: source page_size="
                f"{src_cache.page_size} != pool page_size="
                f"{self.page_size} — prefill and decode replicas must "
                f"share page geometry")
        if set(src_cache.pool) != set(self.pool):
            raise ValueError(
                f"import_request_direct: source arrays "
                f"{sorted(src_cache.pool)} != pool arrays "
                f"{sorted(self.pool)} — kv-dtype tiers of the two "
                f"replicas differ")
        for name, arr in self.pool.items():
            other = src_cache.pool[name]
            if (other.dtype != arr.dtype or other.device != arr.device
                    or other.shape[0] != arr.shape[0]
                    or other.shape[2:] != arr.shape[2:]):
                raise ValueError(
                    f"import_request_direct: source {name} "
                    f"{dtype_name(other.dtype)}{tuple(other.shape)} on "
                    f"{other.device} does not match pool page geometry "
                    f"{dtype_name(arr.dtype)}{tuple(arr.shape)} on "
                    f"{arr.device}")
        n = self._check_admit(slot, total_tokens)
        k = src_cache.pages_for(length)
        if k > n:
            raise ValueError(
                f"import_request_direct: source holds {k} pages but "
                f"total_tokens={total_tokens} only budgets {n}")
        src_ids = src_cache._slot_pages[src_slot][:k]
        pages = self._alloc_with_evict(n)
        try:
            self._move_pages(src_ids, pages[:k], src_cache=src_cache)
        except Exception:
            self.allocator.free(pages)
            raise
        return self._install(slot, pages)

    # ---- KV handoff: per-request page export / import ----
    def export_request(self, slot: int) -> Dict:
        """Export one ACTIVE slot's live KV pages as a handoff payload:
        only the pages covering ``lengths[slot]`` tokens travel (the
        tail reservation holds no KV yet), each pool array as raw
        ``uint8`` bytes with its dtype name and shape, stamped with
        per-array CRCs that :meth:`import_request` verifies first. Pure
        read: the slot's pages, tables and refcounts are untouched."""
        if not self.active[slot]:
            raise ValueError(f"export_request of inactive slot {slot}")
        length = int(self.lengths[slot])
        if length <= 0:
            raise ValueError(
                f"export_request of slot {slot} with no committed "
                f"tokens — hand off only after prefill completes")
        k = self.pages_for(length)
        pages = self._fetch_pages(self._slot_pages[slot][:k])
        arrays = {n: raw_bytes(t) for n, t in pages.items()}
        meta = {n: {"shape": list(t.shape), "dtype": dtype_name(t.dtype)}
                for n, t in pages.items()}
        return {"page_size": self.page_size, "num_pages": k,
                "length": length, "arrays": arrays, "meta": meta,
                "checksums": payload_checksums(arrays)}

    def import_request(self, slot: int, payload: Dict,
                       total_tokens: int) -> np.ndarray:
        """Admit ``slot`` with the full ``total_tokens`` page budget and
        scatter an :meth:`export_request` payload's KV bytes into its
        leading pages (:meth:`_scatter_pages`): byte-identical to having
        prefilled in place. The payload's checksums are verified, and
        its geometry and dtypes validated, before any allocation: a
        corrupt payload raises :class:`~.resilience.CorruptionDetected`
        and a foreign one ``ValueError``, with nothing committed.
        Returns the slot's block-table row; callers set
        ``lengths[slot]`` from the payload."""
        verify_checksums(payload["arrays"], payload.get("checksums"),
                         "handoff_import")
        n = self._check_admit(slot, total_tokens)
        k = int(payload["num_pages"])
        if payload["page_size"] != self.page_size:
            raise ValueError(
                f"import_request: payload page_size="
                f"{payload['page_size']} != pool page_size="
                f"{self.page_size} — prefill and decode replicas must "
                f"share page geometry")
        if k > n:
            raise ValueError(
                f"import_request: payload holds {k} pages but "
                f"total_tokens={total_tokens} only budgets {n}")
        if set(payload["meta"]) != set(self.pool):
            raise ValueError(
                f"import_request: payload arrays "
                f"{sorted(payload['meta'])} != pool arrays "
                f"{sorted(self.pool)} — kv-dtype tiers of the two "
                f"replicas differ")
        arrays = {}
        for name, m in payload["meta"].items():
            want = self.pool[name]
            if m["dtype"] != dtype_name(want.dtype):
                raise ValueError(
                    f"import_request: payload {name} dtype "
                    f"{m['dtype']} != pool dtype "
                    f"{dtype_name(want.dtype)} — a silent cast would "
                    f"break the handoff's byte identity")
            got = tuple(m["shape"])
            if (got[0] != want.shape[0] or got[1] != k
                    or got[2:] != tuple(want.shape[2:])):
                raise ValueError(
                    f"import_request: payload {name} shape {got} does "
                    f"not match pool page shape "
                    f"{(want.shape[0], k) + tuple(want.shape[2:])}")
            arrays[name] = typed_tensor(payload["arrays"][name], m)
        pages = self._alloc_with_evict(n)
        try:
            self._scatter_pages(arrays, pages[:k])
        except Exception:
            self.allocator.free(pages)
            raise
        return self._install(slot, pages)

    def defrag(self):
        """Compact used pages to the front of the pool: the LIVE pages
        move in place in one :func:`_pool_move` (every source page read
        before any is written), block tables, ``_slot_pages`` and the
        prefix trie's held pages are remapped on the host, and the free
        list becomes the contiguous tail. Shared pages move like any
        other. The trash page stays where it is: table entries that
        point at it keep pointing at it. Unused destination pages keep
        their dead contents."""
        used = {p for pages in self._slot_pages for p in pages}
        if self.prefix is not None:
            used |= set(self.prefix.pages())
        used = sorted(used)
        remap = np.arange(self.num_pages, dtype=np.int32)
        moves = []                      # (src, dst) for pages that move
        for new_id, old_id in enumerate(used, start=self.allocator.reserved):
            remap[old_id] = new_id
            if old_id != new_id:
                moves.append((old_id, new_id))
        if moves:
            self._move_pages([m[0] for m in moves], [m[1] for m in moves])
        self.block_tables = np.where(
            self.block_tables == TRASH_PAGE, TRASH_PAGE,
            remap[self.block_tables]).astype(np.int32)
        self._slot_pages = [[int(remap[p]) for p in pages]
                            for pages in self._slot_pages]
        alloc = self.allocator
        new_rc = np.zeros_like(alloc._refcount)
        for old_id in used:
            new_rc[remap[old_id]] = alloc._refcount[old_id]
        alloc._refcount = new_rc
        if self.prefix is not None:
            self.prefix.remap_pages(remap)
        first_free = alloc.reserved + len(used)
        alloc._free = list(range(self.num_pages - 1, first_free - 1, -1))
        alloc.defrags_total += 1
