"""Hierarchical KV tier: a host-RAM page tier under the paged allocator,
swap-in preemption resume, prefix demote / promote and a standing
prefix store.

Counterpart of ``paddle_tpu/serving/host_tier.py``:

- :class:`HostPageStore` — a host page pool. Entries hold each array's
  raw ``uint8`` bytes with its dtype name and shape (the
  :meth:`~.paged_cache.PagedKVCache.export_request` convention, so
  bf16 and the int8 tier's scales round-trip exactly) and per-array
  CRCs, LRU-bounded by a page capacity, with an optional STANDING disk
  layer of one ``.npz`` per prefix chain. Key names
  (:func:`_key_name`) and the ``.npz`` layout are the JAX package's, so
  a store written by either package reads the same way in the other.
- :class:`TieredKVCache` — a :class:`~.paged_cache.PagedKVCache` whose
  evictions move bytes instead of dropping them: a preemption victim's
  live pages SWAP OUT to the store and come back by one scatter instead
  of a replay prefill; a prefix-trie chain evicted under pool pressure
  DEMOTES to the store and the next matching admission PROMOTES it
  back; registered prompt chains write through to the store, so a
  restarted engine on the same ``prefix_store_dir`` hits them.

On the card the page moves are PyTorch index ops and copies, no kernel
of the port's own: :func:`_pool_gather` (``index_select`` into a fresh
device tensor) and the pool's ``_scatter_pages`` (``index_copy_``). A
non-blocking swap-out (the overlapped engine's) queues the gather and
its copy into pinned host memory from PyTorch's caching host allocator
on the caller's current stream, records an event, and keeps the
gathered device tensor alive until :meth:`TieredKVCache.fence_swaps`
waits on that event at the next commit. The victim's pages go back to
the free list at once and a new tenant may write them in the same
step: that is safe only because every launch of the engine orders on
the one stream, so the gather runs before any later write to those
pages (the same fact the supervisor's watchdog thread relies on). A
device-to-host copy into pageable memory would be synchronous, hence
the pinned buffers.

Fault sites: ``swap_out`` fires BEFORE any gather (a fault commits
nothing), ``swap_in`` before any allocation (the payload survives for
the retry, which is bounded with a backoff). Every payload's CRCs are
verified before its bytes are installed: a corrupt swap payload is
quarantined and the request resumes by replay, a corrupt or stale
standing-store chain reads as a prefix miss.
"""
from __future__ import annotations

import hashlib
import json
import os
import time
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np
import torch

from ..observability import hooks as _obs
from .paged_cache import (PagedKVCache, PoolExhausted, dtype_name,
                          raw_bytes, typed_tensor)
from .resilience import (CorruptionDetected, fault_point,
                         payload_checksums, tamper_point, verify_checksums)


def _pool_gather(pool: Dict, src: torch.Tensor) -> Dict:
    """The pages at ids ``src`` of every pool array ``(L, P, page,
    ...)``, each gathered into a fresh tensor on the pool's device."""
    return {name: arr.index_select(1, src) for name, arr in pool.items()}


def _key_name(key: bytes) -> str:
    """The standing store's file name for a prefix-chain key (the
    chain's token bytes): content-addressed, so engines sharing one
    directory converge on the same files."""
    return hashlib.sha1(key).hexdigest() + ".npz"


def _tampered_entry(entry: Dict) -> Dict:
    """A copy of ``entry`` with one payload byte flipped (the injector's
    payload-corruption mode): the CRC verifier, not the injector, must
    catch it."""
    arrays = {n: np.array(a, copy=True)
              for n, a in entry["arrays"].items()}
    name = sorted(arrays)[0]
    flat = arrays[name].reshape(-1).view(np.uint8)
    if flat.size:
        flat[flat.size // 2] ^= 0xFF
    out = {k: v for k, v in entry.items() if k != "tensors"}
    out["arrays"] = arrays
    return out


class HostPageStore:
    """Host page pool: the RAM (+ optional disk) tier below the device.

    Keys: ``("swap", rid)`` for swapped-out requests, a chain prefix's
    raw token bytes for demoted and persisted trie pages. Entries hold
    raw ``uint8`` arrays with dtype / shape metadata and CRCs; an entry
    put from typed CPU tensors also keeps them (``"tensors"``, the same
    memory: pinned host memory after a swap-out on the card, which a
    swap-in uploads without another copy). ``capacity_pages``
    LRU-bounds RAM residency; dropping an entry is always safe (a
    dropped swap payload resumes by replay, a dropped prefix page is a
    miss). ``path`` adds the standing tier: entries put with
    ``persist=True`` also land on disk, one ``.npz`` each, and a RAM
    miss falls through to disk. ``max_disk_bytes`` bounds the disk
    layer, pruning the oldest-modified files first."""

    def __init__(self, page_size: int,
                 capacity_pages: Optional[int] = None,
                 path: Optional[str] = None,
                 max_disk_bytes: Optional[int] = None):
        if capacity_pages is not None and capacity_pages < 1:
            raise ValueError(
                f"HostPageStore: capacity_pages={capacity_pages} "
                f"must be >= 1 (or None for unbounded)")
        if max_disk_bytes is not None and max_disk_bytes < 1:
            raise ValueError(
                f"HostPageStore: max_disk_bytes={max_disk_bytes} "
                f"must be >= 1 (or None for unbounded)")
        self.page_size = page_size
        self.capacity_pages = capacity_pages
        self.path = path
        self.max_disk_bytes = max_disk_bytes
        self._entries: "OrderedDict" = OrderedDict()
        self.pages_resident = 0
        self.bytes_resident = 0
        self.puts_total = 0
        self.hits_total = 0
        self.misses_total = 0
        self.capacity_drops_total = 0
        #: corrupt or torn entries removed so they are never served again
        self.quarantined_total = 0
        #: standing-store files (and bytes) removed by the disk bound
        self.disk_pruned_total = 0
        self.disk_pruned_bytes_total = 0
        # the standing store's bytes, kept up to date on every write and
        # re-read from the directory only when the bound trips
        self._disk_bytes: Optional[int] = None
        if path is not None:
            os.makedirs(path, exist_ok=True)
            if max_disk_bytes is not None:
                self._disk_bytes = sum(
                    os.path.getsize(os.path.join(path, f))
                    for f in os.listdir(path) if f.endswith(".npz"))

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key) -> bool:
        return self.contains(key)

    def contains(self, key) -> bool:
        """Existence probe without side effects: RAM membership plus a
        disk ``stat`` for bytes keys; no read, no LRU bump, no count."""
        if key in self._entries:
            return True
        return (self.path is not None and isinstance(key, bytes)
                and os.path.exists(
                    os.path.join(self.path, _key_name(key))))

    @staticmethod
    def encode(arrays: Dict) -> Dict:
        """Pack typed arrays (CPU tensors, or numpy arrays) into the
        raw-``uint8`` + metadata payload form, stamped with per-array
        CRCs. Tensors are viewed, not copied, and kept under
        ``"tensors"``."""
        enc, meta, tensors, pages = {}, {}, {}, 0
        for name, a in arrays.items():
            if isinstance(a, torch.Tensor):
                a = a.contiguous()
                tensors[name] = a
                enc[name] = raw_bytes(a)
                meta[name] = {"shape": list(a.shape),
                              "dtype": dtype_name(a.dtype)}
            else:
                a = np.ascontiguousarray(a)
                enc[name] = a.reshape(-1).view(np.uint8)
                meta[name] = {"shape": list(a.shape), "dtype": str(a.dtype)}
            if len(meta[name]["shape"]) >= 2:
                pages = max(pages, int(meta[name]["shape"][1]))
        entry = {"arrays": enc, "meta": meta, "pages": pages,
                 "bytes": sum(int(v.nbytes) for v in enc.values()),
                 "checksums": payload_checksums(enc)}
        if tensors:
            entry["tensors"] = tensors
        return entry

    @staticmethod
    def decode(entry: Dict) -> Dict[str, torch.Tensor]:
        """Unpack a payload into typed CPU tensors (the tensors it was
        put from, when it kept them)."""
        kept = entry.get("tensors") or {}
        return {name: kept[name] if name in kept
                else typed_tensor(entry["arrays"][name], m)
                for name, m in entry["meta"].items()}

    def _account(self, entry: Dict, sign: int):
        self.pages_resident += sign * entry["pages"]
        self.bytes_resident += sign * entry["bytes"]

    def _publish(self):
        _obs.serving_host_pool(self.pages_resident, self.bytes_resident,
                               self.capacity_pages)

    def put(self, key, arrays: Dict, extra: Optional[Dict] = None,
            persist: bool = False) -> Dict:
        """Store ``arrays`` under ``key``; returns the encoded entry.
        ``persist=True`` (bytes keys only: prefix chains) also writes
        the standing ``.npz`` when the store has a disk path.
        Over-capacity RAM entries drop LRU-first; persisted ones stay
        readable from disk."""
        if persist and not isinstance(key, bytes):
            raise ValueError(
                "HostPageStore: only bytes keys (prefix-chain token "
                "bytes) persist to the standing store")
        entry = self.encode(arrays)
        entry["extra"] = dict(extra or {})
        entry["persist"] = bool(persist)
        old = self._entries.pop(key, None)
        if old is not None:
            self._account(old, -1)
        self._entries[key] = entry
        self._account(entry, +1)
        self.puts_total += 1
        self._enforce_capacity()
        if persist and self.path is not None:
            self._write_disk(key, entry)
        self._publish()
        return entry

    def _enforce_capacity(self):
        """Drop LRU entries until RAM residency fits ``capacity_pages``
        (shared by :meth:`put` and :meth:`get`'s disk-to-RAM
        promotion)."""
        if self.capacity_pages is None:
            return
        while (self.pages_resident > self.capacity_pages
               and len(self._entries) > 1):
            _, dropped = self._entries.popitem(last=False)
            self._account(dropped, -1)
            self.capacity_drops_total += 1

    def _write_disk(self, key: bytes, entry: Dict):
        meta = {"meta": entry["meta"], "pages": entry["pages"],
                "extra": entry["extra"],
                "checksums": entry.get("checksums")}
        fn = os.path.join(self.path, _key_name(key))
        tmp = fn + ".tmp"
        old_size = 0
        if self._disk_bytes is not None:
            try:
                old_size = os.path.getsize(fn)
            except OSError:
                pass
        with open(tmp, "wb") as f:
            np.savez(f, key=np.frombuffer(key, np.uint8),
                     meta=np.frombuffer(json.dumps(meta).encode(),
                                        np.uint8),
                     **{f"a_{n}": a for n, a in entry["arrays"].items()})
        os.replace(tmp, fn)     # atomic: a reader never sees half a file
        if self._disk_bytes is not None:
            try:
                self._disk_bytes += os.path.getsize(fn) - old_size
            except OSError:
                pass
            if self._disk_bytes > self.max_disk_bytes:
                self._enforce_disk_bound(keep=fn)

    def _enforce_disk_bound(self, keep: Optional[str] = None) -> int:
        """Prune the oldest-modified standing-store files until the disk
        layer fits ``max_disk_bytes``; the file just written (``keep``)
        never goes. Best-effort: a file another engine removed first is
        skipped."""
        if self.max_disk_bytes is None or self.path is None:
            return 0
        try:
            files = []
            total = 0
            for fn in os.listdir(self.path):
                if not fn.endswith(".npz"):
                    continue
                full = os.path.join(self.path, fn)
                try:
                    st = os.stat(full)
                except OSError:
                    continue
                files.append((st.st_mtime, st.st_size, full))
                total += st.st_size
            pruned = 0
            for _mtime, size, full in sorted(files):
                if total <= self.max_disk_bytes:
                    break
                if full == keep:
                    continue
                try:
                    os.unlink(full)
                except OSError:
                    continue
                total -= size
                pruned += 1
                self.disk_pruned_total += 1
                self.disk_pruned_bytes_total += size
            self._disk_bytes = total
            if pruned:
                _obs.serving_host_disk_pruned(
                    pruned, self.disk_pruned_bytes_total)
            return pruned
        except OSError:
            return 0

    def _quarantine_disk(self, fn: str):
        """Remove a corrupt or torn standing-store file so that it is
        never read again (counted even when the unlink fails)."""
        self.quarantined_total += 1
        _obs.serving_integrity("disk_store", "quarantined")
        self._unlink_tracked(fn)

    def _unlink_tracked(self, fn: str) -> None:
        size = 0
        if self._disk_bytes is not None:
            try:
                size = os.path.getsize(fn)
            except OSError:
                pass
        try:
            os.unlink(fn)
        except OSError:
            return
        if self._disk_bytes is not None:
            self._disk_bytes = max(0, self._disk_bytes - size)

    def _read_disk(self, key: bytes) -> Optional[Dict]:
        fn = os.path.join(self.path, _key_name(key))
        if not os.path.exists(fn):
            return None
        try:
            with np.load(fn) as data:
                meta = json.loads(bytes(data["meta"]).decode())
                entry = {"arrays": {n[2:]: np.asarray(data[n])
                                    for n in data.files
                                    if n.startswith("a_")},
                         "meta": meta["meta"], "pages": meta["pages"],
                         "extra": meta["extra"], "persist": True,
                         "checksums": meta.get("checksums")}
        except Exception:
            # torn, truncated or foreign file: quarantined, and the
            # caller serves a plain miss
            _obs.serving_integrity("disk_store", "detected")
            self._quarantine_disk(fn)
            return None
        try:
            # bit flips np.load cannot see
            verify_checksums(entry["arrays"], entry.get("checksums"),
                             "disk_store")
        except CorruptionDetected:
            _obs.serving_integrity("disk_store", "detected")
            self._quarantine_disk(fn)
            return None
        entry["bytes"] = sum(int(v.nbytes)
                             for v in entry["arrays"].values())
        try:
            # a read counts as a use for the disk bound's pruning order
            os.utime(fn, None)
        except OSError:
            pass
        return entry

    def get(self, key, touch: bool = True) -> Optional[Dict]:
        """RAM lookup, falling through to the standing disk tier for
        bytes keys; a disk hit enters RAM. ``touch`` bumps LRU recency
        and counts the hit or miss."""
        entry = self._entries.get(key)
        if entry is None and self.path is not None \
                and isinstance(key, bytes):
            entry = self._read_disk(key)
            if entry is not None:
                self._entries[key] = entry
                self._account(entry, +1)
                self._enforce_capacity()
                self._publish()
        if entry is None:
            if touch:
                self.misses_total += 1
            return None
        if touch:
            self.hits_total += 1
            self._entries.move_to_end(key)
        return entry

    def pop(self, key) -> Optional[Dict]:
        entry = self._entries.pop(key, None)
        if entry is not None:
            self._account(entry, -1)
            self._publish()
        return entry

    def quarantine(self, key, site: str) -> None:
        """Remove a corrupt entry everywhere it could be served from
        (RAM and, for a persisted bytes key, its disk file) and count
        it: the next lookup is an honest miss."""
        self.pop(key)
        self.quarantined_total += 1
        _obs.serving_integrity(site, "quarantined")
        if self.path is not None and isinstance(key, bytes):
            self._unlink_tracked(
                os.path.join(self.path, _key_name(key)))

    def stats(self) -> Dict:
        return {"entries": len(self._entries),
                "pages_resident": self.pages_resident,
                "bytes_resident": self.bytes_resident,
                "capacity_pages": self.capacity_pages,
                "puts_total": self.puts_total,
                "hits_total": self.hits_total,
                "misses_total": self.misses_total,
                "capacity_drops_total": self.capacity_drops_total,
                "quarantined_total": self.quarantined_total,
                "disk_pruned_total": self.disk_pruned_total,
                "disk_pruned_bytes_total": self.disk_pruned_bytes_total}


class TieredKVCache(PagedKVCache):
    """A :class:`~.paged_cache.PagedKVCache` with the host tier under its
    allocator (module docstring): preemption victims swap out to a
    :class:`HostPageStore` and resume by one scatter; prefix chains
    evicted under pool pressure demote and promote back; registered
    prompt chains write through to the store (``prefix_store_dir``).

    ``store`` shares one :class:`HostPageStore` across caches.
    ``host_capacity_pages`` bounds its RAM, ``persist_prefix=False``
    turns the write-through off, ``swap_in_retries`` bounds the
    in-place retries of a faulted swap-in (``retry_sleep`` waits
    between them)."""

    def __init__(self, cfg, max_batch: int, max_len: int, *,
                 host_capacity_pages: Optional[int] = None,
                 prefix_store_dir: Optional[str] = None,
                 persist_prefix: bool = True,
                 store: Optional[HostPageStore] = None,
                 swap_in_retries: int = 2,
                 retry_sleep=time.sleep, **kw):
        super().__init__(cfg, max_batch, max_len, **kw)
        self.host = store if store is not None else HostPageStore(
            self.page_size, capacity_pages=host_capacity_pages,
            path=prefix_store_dir)
        self.persist_prefix = persist_prefix
        self.swap_in_retries = int(swap_in_retries)
        self._retry_sleep = retry_sleep
        self.swap_outs_total = 0
        self.swap_ins_total = 0
        self.swap_out_bytes_total = 0
        self.swap_in_bytes_total = 0
        self.swap_in_pages_total = 0
        self.swap_replay_fallbacks = 0
        self.swap_in_retries_total = 0
        #: why the LAST swap_in fell back to replay ("dropped" | "stale"
        #: | "corrupt"; None after a success)
        self.last_swap_fallback: Optional[str] = None
        self.corruptions_detected_total = 0
        self.demotions_total = 0
        self.promote_hits_total = 0
        self._swap_charge = 0   # pending planner debit, tokens
        # non-blocking swap-outs issued but not fenced into the store
        # yet: key -> {host tensors, device tensors, event, length,
        # pages, t0}. Every store read fences first.
        self._pending_swaps: "OrderedDict" = OrderedDict()
        #: the last swap-ins' host wall milliseconds (bounded)
        self.swap_in_ms: List[float] = []

    # ---- page moves ----
    def _gather_device(self, ids) -> Dict:
        """Queue the gather of the pages at ``ids`` and their copy to
        host; returns ``(device tensors, host tensors, event)``, the
        host tensors valid once the event completed (None on the CPU,
        where the gather is the host copy)."""
        self._release_held()
        dev = _pool_gather(self.pool, self._ids(ids))
        if self.device.type != "cuda":
            return dev, dev, None
        host = {}
        for name, g in dev.items():
            h = torch.empty(g.shape, dtype=g.dtype, pin_memory=True)
            h.copy_(g, non_blocking=True)
            host[name] = h
        ev = torch.cuda.Event()
        ev.record()
        return dev, host, ev

    def _decode_validated(self, entry: Dict, k: Optional[int] = None,
                          site: str = "host_payload") -> Dict:
        """Verify a host payload's CRCs (:class:`~.resilience.
        CorruptionDetected` before anything else), then validate it
        against THIS pool's geometry (array set, dtypes, layer and page
        shape), and decode it. A stale standing store from another
        configuration raises ``ValueError``: a miss on the prefix path,
        never a wrong scatter."""
        verify_checksums(entry["arrays"], entry.get("checksums"), site)
        if set(entry["meta"]) != set(self.pool):
            raise ValueError(
                f"host payload arrays {sorted(entry['meta'])} != pool "
                f"arrays {sorted(self.pool)} — kv-dtype tier mismatch")
        for name, m in entry["meta"].items():
            want = self.pool[name]
            if m["dtype"] != dtype_name(want.dtype):
                raise ValueError(
                    f"host payload {name} dtype {m['dtype']} != pool "
                    f"dtype {dtype_name(want.dtype)}")
            got = tuple(m["shape"])
            kk = got[1] if k is None else k
            if (got[0] != want.shape[0] or got[1] != kk
                    or got[2:] != tuple(want.shape[2:])):
                raise ValueError(
                    f"host payload {name} shape {got} does not match "
                    f"pool page shape "
                    f"{(want.shape[0], kk) + tuple(want.shape[2:])}")
        return HostPageStore.decode(entry)

    # ---- swap-out / swap-in (the preemption tier) ----
    @staticmethod
    def _swap_key(rid: int):
        return ("swap", int(rid))

    def swap_out(self, slot: int, rid: int,
                 nonblocking: bool = False) -> int:
        """Preemption SWAP-OUT: gather ``slot``'s live pages (those
        covering ``lengths[slot]`` committed tokens) to the host store
        under ``rid``, then release the device pages as
        :meth:`~.paged_cache.PagedKVCache.evict_for_preempt` does.
        Returns the pages freed. The fault site fires BEFORE the
        gather, so a fault commits nothing.

        ``nonblocking=True`` (the overlapped engine): the gather and the
        copy to pinned host memory are queued here, and the store entry
        materializes at the next :meth:`fence_swaps` (module docstring);
        every store read fences first."""
        if not self.active[slot]:
            raise ValueError(f"swap_out of inactive slot {slot}")
        length = int(self.lengths[slot])
        if length <= 0:
            raise ValueError(
                f"swap_out of slot {slot} with no committed tokens — "
                f"mid-prefill victims evict and replay instead")
        fault_point("swap_out")
        t0 = time.perf_counter_ns()
        k = self.pages_for(length)
        ids = self._slot_pages[slot][:k]
        if nonblocking:
            dev, host, ev = self._gather_device(ids)
            self._pending_swaps[self._swap_key(rid)] = {
                "host": host, "dev": dev, "event": ev, "length": length,
                "pages": k, "t0": t0}
            return self.evict_for_preempt(slot)
        arrays = self._fetch_pages(ids)
        entry = self.host.put(self._swap_key(rid), arrays,
                              extra={"length": length})
        freed = self.evict_for_preempt(slot)
        self.swap_outs_total += 1
        self.swap_out_bytes_total += entry["bytes"]
        _obs.serving_swap_out(t0, entry["bytes"], k)
        return freed

    def fence_swaps(self) -> int:
        """Materialize every pending non-blocking swap-out into the host
        store: wait on its event, then put its pinned host tensors. The
        ``serving_swap_out`` histogram spans issue to fence. Returns the
        number fenced."""
        if not self._pending_swaps:
            return 0
        n = 0
        pend, self._pending_swaps = self._pending_swaps, OrderedDict()
        for key, ent in pend.items():
            if ent["event"] is not None:
                ent["event"].synchronize()
            entry = self.host.put(key, ent["host"],
                                  extra={"length": ent["length"]})
            self.swap_outs_total += 1
            self.swap_out_bytes_total += entry["bytes"]
            _obs.serving_swap_out(ent["t0"], entry["bytes"], ent["pages"])
            n += 1
        return n

    def has_swapped(self, rid: int) -> bool:
        key = self._swap_key(rid)
        return key in self._pending_swaps or self.host.contains(key)

    def drop_swapped(self, rid: int) -> None:
        """Retire a swapped payload (its request finished or was
        cancelled while evicted): always safe, never required."""
        self._pending_swaps.pop(self._swap_key(rid), None)
        self.host.pop(self._swap_key(rid))

    def _quarantine_swap_in(self, rid: int) -> None:
        """A corrupt swap payload: quarantined (counted, never served
        again) and the resume counted as a fallback to replay, which
        recomputes the KV from the request's tokens."""
        self.corruptions_detected_total += 1
        _obs.serving_integrity("swap_in", "detected")
        self.host.quarantine(self._swap_key(rid), "swap_in")
        self.swap_replay_fallbacks += 1
        _obs.serving_swap_fallback()
        _obs.serving_integrity("swap_in", "replayed")

    def swap_in(self, slot: int, rid: int, total_tokens: int,
                expect_tokens: int) -> Optional[int]:
        """Preemption SWAP-IN: re-admit ``rid`` on ``slot`` with its full
        ``total_tokens`` page budget and scatter the swapped payload's
        bytes into the leading pages. Returns the restored committed
        length, or None when no valid payload exists (dropped, stale
        against ``expect_tokens``, or corrupt) and the caller must
        resume by replay. Raises :class:`~.paged_cache.PoolExhausted`
        with nothing committed (the payload survives for the retry). A
        fault inside an attempt frees what it allocated and retries in
        place, at most ``swap_in_retries`` times."""
        self.fence_swaps()      # a pending payload must be visible
        entry = self.host.get(self._swap_key(rid))
        if entry is None:
            self.last_swap_fallback = "dropped"
            self.swap_replay_fallbacks += 1
            _obs.serving_swap_fallback()
            return None
        length = int(entry["extra"]["length"])
        if length != int(expect_tokens):
            self.last_swap_fallback = "stale"
            self.drop_swapped(rid)
            self.swap_replay_fallbacks += 1
            _obs.serving_swap_fallback()
            return None
        if tamper_point("swap_in"):
            # injected payload corruption: real bytes flip, the CRC
            # check below must catch them
            entry = _tampered_entry(entry)
        t0 = time.perf_counter_ns()
        n = self._check_admit(slot, total_tokens)
        k = self.pages_for(length)
        try:
            arrays = self._decode_validated(entry, k=k, site="swap_in")
        except CorruptionDetected:
            self.last_swap_fallback = "corrupt"
            self._quarantine_swap_in(rid)
            return None
        attempt = 0
        while True:
            try:
                fault_point("swap_in")
                pages = self._alloc_with_evict(n)
                try:
                    self._scatter_pages(arrays, pages[:k])
                except Exception:
                    self.allocator.free(pages)
                    raise
                break
            except PoolExhausted:
                raise
            except CorruptionDetected:
                self.last_swap_fallback = "corrupt"
                self._quarantine_swap_in(rid)
                return None
            except Exception:
                attempt += 1
                if attempt > self.swap_in_retries:
                    raise
                self.swap_in_retries_total += 1
                _obs.serving_integrity_retry("swap_in")
                self._retry_sleep(min(0.2, 0.005 * 2 ** (attempt - 1)))
        self._install(slot, pages)
        self.lengths[slot] = length
        self.last_swap_fallback = None
        self.host.pop(self._swap_key(rid))
        self.swap_ins_total += 1
        self.swap_in_pages_total += k
        self.swap_in_bytes_total += entry["bytes"]
        self._swap_charge += k * self.page_size
        self.swap_in_ms.append((time.perf_counter_ns() - t0) / 1e6)
        del self.swap_in_ms[:-1024]
        _obs.serving_swap_in(t0, entry["bytes"], k)
        return length

    def consume_swap_charge(self) -> int:
        """Token-equivalent debit of the swap-ins since the last call:
        ``page_size`` tokens per swapped-in page, the rate a prefill
        chunk is charged. The scheduler reserves it out of the step's
        token budget."""
        c = self._swap_charge
        self._swap_charge = 0
        return c

    # ---- prefix demote / promote / standing store ----
    def _chain_key(self, prompt: np.ndarray, n_pages: int) -> bytes:
        return np.ascontiguousarray(
            prompt[:n_pages * self.page_size]).tobytes()

    def register_prefix(self, slot: int, prompt):
        """Publish the prompt's pages to the trie, and write each full
        page through to the host store (and its disk layer), unless
        already there."""
        super().register_prefix(slot, prompt)
        if self.prefix is None or not self.persist_prefix:
            return
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0 or not self.active[slot]:
            return
        pg = self.page_size
        nfull = prompt.size // pg
        missing = [j for j in range(nfull)
                   if not self.host.contains(
                       self._chain_key(prompt, j + 1))]
        if not missing:
            return
        pages = self._slot_pages[slot]
        gathered = self._fetch_pages([pages[j] for j in missing])
        for i, j in enumerate(missing):
            self.host.put(
                self._chain_key(prompt, j + 1),
                {n: a[:, i:i + 1] for n, a in gathered.items()},
                extra={"tokens": prompt[:(j + 1) * pg].tolist()},
                persist=True)

    def _evict_prefix(self, need: int) -> int:
        """Trie eviction under pool pressure, with DEMOTION: each full
        page dropped from the trie lands in the host store first, keyed
        by its chain, unless already written through; one gather serves
        the whole batch. Partial-page tails do not demote."""
        pend: List = []

        def demote(chain_tokens: np.ndarray, page: int):
            key = chain_tokens.tobytes()
            if not self.host.contains(key):
                pend.append((key, chain_tokens, page))
            self.demotions_total += 1
            _obs.serving_prefix_demoted(1)
        freed = self.prefix.evict(self.allocator, need, on_evict=demote)
        if pend:
            # the gather is queued before the caller's allocation writes
            # anything into the freed pages, and waited for here
            gathered = self._fetch_pages([p for _, _, p in pend])
            for i, (key, toks, _page) in enumerate(pend):
                self.host.put(key,
                              {n: a[:, i:i + 1]
                               for n, a in gathered.items()},
                              extra={"tokens": toks.tolist()},
                              persist=self.persist_prefix)
        return freed

    def admit_prompt(self, slot: int, prompt, total_tokens: int):
        """The parent's admission, preceded by PROMOTION: host chains
        that extend past the device trie's match scatter back into fresh
        pages and register, so the admission hits them."""
        if self.prefix is not None:
            self._promote_prefix(
                np.asarray(prompt, np.int32).reshape(-1))
        return super().admit_prompt(slot, prompt, total_tokens)

    def _promote_prefix(self, prompt: np.ndarray) -> int:
        pg = self.page_size
        max_full = max(0, (prompt.size - 1) // pg)
        if max_full == 0:
            return 0
        matched, _ = self.prefix.match(prompt)
        entries = []
        j = len(matched)
        while j < max_full:
            entry = self.host.get(self._chain_key(prompt, j + 1))
            if entry is None:
                break
            entries.append(entry)
            j += 1
        if not entries:
            return 0
        t0 = time.perf_counter_ns()
        try:
            arrays = [self._decode_validated(e, k=1,
                                             site="prefix_promote")
                      for e in entries]
        except CorruptionDetected:
            # a corrupt chain: every entry of it quarantined, and the
            # admission is a plain miss that prefills again
            self.corruptions_detected_total += 1
            _obs.serving_integrity("prefix_promote", "detected")
            for jj in range(len(matched), len(matched) + len(entries)):
                self.host.quarantine(self._chain_key(prompt, jj + 1),
                                     "prefix_promote")
            _obs.serving_integrity("prefix_promote", "replayed")
            return 0
        except ValueError:
            # a stale store (another geometry or kv tier): drop the
            # chain and serve a plain miss
            for jj in range(len(matched), len(matched) + len(entries)):
                self.host.pop(self._chain_key(prompt, jj + 1))
            return 0
        # pin the matched span FIRST: the eviction our own allocation may
        # trigger must not recycle a matched page mid-promotion (two
        # chain nodes on one physical page)
        matched = list(matched)
        self.allocator.share(matched)
        try:
            fresh = self._alloc_with_evict(len(entries))
        except PoolExhausted:
            self.allocator.free(matched)
            return 0            # no room to promote: a plain miss
        try:
            merged = {n: torch.cat([a[n] for a in arrays], dim=1)
                      for n in arrays[0]}
            self._scatter_pages(merged, fresh)
            span = len(matched) + len(entries)
            self.prefix.register(prompt[:span * pg], matched + fresh,
                                 self.allocator)
        except Exception:
            self.allocator.free(matched + fresh)
            raise
        # the trie owns the pages now; drop the pins and bootstrap refs
        self.allocator.free(matched + fresh)
        self.promote_hits_total += len(entries)
        _obs.serving_prefix_promoted(t0, len(entries))
        return len(entries)

    # ---- supervisor integration ----
    def adopt_host_tier(self, old: "TieredKVCache") -> None:
        """Carry the host tier across an engine rebuild: the store is
        host state committed only after gathers that completed, so it
        survives a poisoned device pool and recovery swaps sessions in
        instead of replaying them. Lifetime counters carry too. Pending
        swap-outs fence into the store first; a fence that fails drops
        them (those resumes replay)."""
        try:
            old.fence_swaps()
        except Exception:
            old._pending_swaps.clear()
        self.host = old.host
        self.persist_prefix = old.persist_prefix
        for name in ("swap_outs_total", "swap_ins_total",
                     "swap_out_bytes_total", "swap_in_bytes_total",
                     "swap_in_pages_total", "swap_replay_fallbacks",
                     "swap_in_retries_total",
                     "corruptions_detected_total",
                     "demotions_total", "promote_hits_total"):
            setattr(self, name, getattr(old, name))
        self.swap_in_ms = old.swap_in_ms
        self.swap_in_retries = old.swap_in_retries
        self._retry_sleep = old._retry_sleep

    def tier_stats(self) -> Dict:
        s = {"swap_outs_total": self.swap_outs_total,
             "swap_outs_pending": len(self._pending_swaps),
             "swap_ins_total": self.swap_ins_total,
             "swap_out_bytes_total": self.swap_out_bytes_total,
             "swap_in_bytes_total": self.swap_in_bytes_total,
             "swap_replay_fallbacks": self.swap_replay_fallbacks,
             "swap_in_retries_total": self.swap_in_retries_total,
             "corruptions_detected_total":
                 self.corruptions_detected_total,
             "prefix_demotions_total": self.demotions_total,
             "prefix_promote_hits_total": self.promote_hits_total}
        s.update({f"host_{k}": v for k, v in self.host.stats().items()})
        return s
