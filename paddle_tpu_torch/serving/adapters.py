"""Multi-tenant adapter pool: paged multi-LoRA serving.

Counterpart of ``paddle_tpu/serving/adapters.py`` on one device. One
engine serves many fine-tuned variants of its base weights: a
device-resident pool of fixed SLOTS of packed low-rank factors, each
request's ``adapter_id`` gathered into every forward, refcounted
residency with LRU reclaim, and the host tier below it
(:class:`~.host_tier.HostPageStore`) that cold adapters demote into and
promote back from.

The reference's design carries over as it is:

- **q/o-projection adapters only** (``wq`` and ``wo`` grow the
  ``y += (x @ A_i) @ B_i * alpha/r`` term, :func:`~..models.generate.
  _lora_delta`). k/v adapters would make the cached KV depend on the
  tenant; q/o ones leave it adapter-agnostic, so prefix sharing, swap
  payloads and the handoff ride unchanged. Registration rejects k/v
  factors.
- **Slot 0 is the base model**: its factors and scale are exact zeros,
  so a row with ``adapter_id=0`` adds an exact zero, and an engine with
  a pool serves base rows bit-identically to one without.
- **One rank bucket per pool**: smaller-rank adapters zero-pad into
  ``rank``; the padded columns contribute exact zeros.
- **Host tier below the slots**: an LRU-evicted adapter DEMOTES its
  CRC-stamped factors to the store under ``b"adapter/<id>"`` with
  ``persist=True`` (the standing on-disk layer, in the same ``.npz``
  layout as the JAX package's, so either package promotes what the
  other demoted) and PROMOTES back on the next admission that pins it;
  a corrupt payload is quarantined and the admission falls back to the
  registry, counted (``serving_adapter_fallbacks_total``).

Fault sites: ``adapter_load`` fires before a registry load installs
anything, ``adapter_promote`` before a host-store promotion does, so a
fault at either commits nothing and the retried admission finds the
same sources.

The pool's tensors are ``(L, slots + 1, in, r)`` / ``(L, slots + 1, r,
out)`` in ``cfg.dtype`` on the engine's device, plus a ``(slots + 1,)``
f32 scale. An install writes the whole slot row in place (the stale rank
columns of a reclaimed slot included) with copies queued on the card's
stream from pinned host memory, so it never waits for the card.
``mesh=`` (tensor-parallel pools) waits for ROADMAP.md's queue A step 7.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..observability import hooks as _obs
from .paged_cache import PoolExhausted
from .resilience import CorruptionDetected, fault_point, verify_checksums

#: the four packed factor arrays of one adapter, in pool order; every
#: payload, registry entry and device pool carries exactly this set
FACTOR_NAMES = ("aq", "bq", "ao", "bo")


class AdapterPoolExhausted(PoolExhausted):
    """Every usable adapter slot is pinned by a running request. A
    :class:`~.paged_cache.PoolExhausted` on purpose: the engine and
    scheduler admission paths treat that as back-pressure (defer until
    running requests retire)."""


def _factor_shapes(cfg, rank: int) -> Dict[str, tuple]:
    """Per-layer packed factor shapes for one adapter at ``rank``."""
    h, dq = cfg.hidden_size, cfg.num_heads * cfg.hd
    return {"aq": (cfg.num_layers, h, rank),
            "bq": (cfg.num_layers, rank, dq),
            "ao": (cfg.num_layers, dq, rank),
            "bo": (cfg.num_layers, rank, h)}


def init_lora(cfg, rank: int, seed: int = 0, *,
              alpha: Optional[float] = None, scale: float = 0.02) -> Dict:
    """A random q/o LoRA adapter (tests, the chip smoke): small gaussian
    ``A`` and ``B`` factors from ``numpy.random.RandomState(seed)`` (a
    NONZERO ``B``, so no parity check is vacuous), the same arrays the
    JAX package makes from the same seed. Returns the entry shape
    :meth:`AdapterRegistry.register` accepts."""
    rs = np.random.RandomState(seed)
    out = {name: (rs.standard_normal(shape) * scale).astype(np.float32)
           for name, shape in _factor_shapes(cfg, rank).items()}
    out["alpha"] = float(alpha if alpha is not None else rank)
    return out


def merge_lora(params: Dict, cfg, adapter: Dict) -> Dict:
    """Dense-merge one adapter into a COPY of the port's parameter dict:
    ``wq += A_q @ B_q * alpha/r`` and ``wo += A_o @ B_o * alpha/r`` in
    f32, cast back to the weights' dtype: the single-model reference an
    adapter row is held to. Quantized weights refuse (the engine applies
    adapters as a separate term so low-bit weights never requantize)."""
    layers = dict(params["layers"])
    if "wq_scale" in layers:
        raise ValueError(
            "merge_lora: cannot dense-merge into quantized weights — "
            "merge into the fp tree before quantize_weights, or serve "
            "the adapter through the AdapterPool term")
    sc = float(adapter["alpha"]) / adapter["aq"].shape[-1]
    for w, a, b in (("wq", "aq", "bq"), ("wo", "ao", "bo")):
        base = layers[w]
        fa = torch.as_tensor(np.asarray(adapter[a], np.float32),
                             device=base.device)
        fb = torch.as_tensor(np.asarray(adapter[b], np.float32),
                             device=base.device)
        delta = torch.einsum("lhr,lro->lho", fa, fb) * sc
        layers[w] = (base.float() + delta).to(base.dtype)
    return {**params, "layers": layers}


class AdapterRegistry:
    """Host-side source of truth: ``adapter_id -> packed factors``,
    shared read-mostly across engines. Registration validates shapes
    and rejects k/v-projection factors."""

    def __init__(self, cfg):
        self.cfg = cfg
        self._entries: Dict[int, Dict] = {}

    def register(self, adapter_id: int, factors: Dict) -> None:
        """Install ``factors`` (the :func:`init_lora` shape: the four
        per-layer stacked arrays and ``alpha``) under ``adapter_id``.
        Id 0 is the base model and cannot be registered."""
        aid = int(adapter_id)
        if aid <= 0:
            raise ValueError(
                f"adapter_id {aid} is reserved (0 = the base model); "
                f"register adapters at ids >= 1")
        unknown = set(factors) - set(FACTOR_NAMES) - {"alpha"}
        if unknown:
            raise ValueError(
                f"register: unknown factor(s) {sorted(unknown)} — only "
                f"q/o-projection adapters are servable ({FACTOR_NAMES}); "
                f"k/v factors would fork the cached KV per tenant")
        missing = set(FACTOR_NAMES) - set(factors)
        if missing:
            raise ValueError(f"register: missing factor(s) "
                             f"{sorted(missing)}")
        rank = int(factors["aq"].shape[-1])
        want = _factor_shapes(self.cfg, rank)
        packed = {}
        for name in FACTOR_NAMES:
            a = np.asarray(factors[name], np.float32)
            if tuple(a.shape) != want[name]:
                raise ValueError(
                    f"register: {name} shape {tuple(a.shape)} != "
                    f"{want[name]} (rank inferred from aq: {rank})")
            packed[name] = a
        packed["alpha"] = float(factors.get("alpha", rank))
        packed["rank"] = rank
        self._entries[aid] = packed

    def get(self, adapter_id: int) -> Optional[Dict]:
        return self._entries.get(int(adapter_id))

    def __contains__(self, adapter_id) -> bool:
        return int(adapter_id) in self._entries

    def ids(self):
        return sorted(self._entries)


class AdapterPool:
    """Device-resident slots of packed per-layer LoRA factors, paged
    like KV.

    ``slots`` counts USABLE slots; slot 0 is the base model besides
    (exact zeros), so the tensors hold ``slots + 1`` entries. ``rank``
    is the pool's rank bucket. ``registry`` is the shared
    :class:`AdapterRegistry`; ``store`` an optional
    :class:`~.host_tier.HostPageStore` that cold adapters demote into
    (and, with a disk path, persist in across restarts). ``device``
    defaults to the card; an engine given a dict builds the pool on its
    own device.

    Residency: :meth:`acquire` pins one reference per RUNNING row (rows
    sharing an adapter pin the same slot), :meth:`release` drops it, and
    an admission that needs a non-resident adapter reclaims the LRU
    UNPINNED slot, demoting its factors first. With every slot pinned
    it raises :class:`AdapterPoolExhausted` (back-pressure). The books
    are host-side; the only device work is one install per load."""

    def __init__(self, cfg, *, slots: int = 8, rank: int = 8,
                 registry: Optional[AdapterRegistry] = None,
                 store=None, mesh=None, device: DeviceLike = None):
        if mesh is not None:
            raise NotImplementedError(
                "AdapterPool: mesh (a tensor-parallel pool) is not "
                "ported yet — see ROADMAP.md, queue A step 7")
        if slots < 1:
            raise ValueError(f"AdapterPool: slots={slots} must be >= 1")
        if rank < 1:
            raise ValueError(f"AdapterPool: rank={rank} must be >= 1")
        self.cfg = cfg
        self.slots = int(slots)
        self.rank = int(rank)
        self.registry = (registry if registry is not None
                         else AdapterRegistry(cfg))
        self.store = store
        self.device = resolve_device(device)
        self.dtype = cfg.dtype
        S = self.slots + 1                        # + the base slot 0
        self.arrays: Dict[str, torch.Tensor] = {
            name: torch.zeros((shp[0], S) + shp[1:], dtype=self.dtype,
                              device=self.device)
            for name, shp in _factor_shapes(cfg, self.rank).items()}
        self.arrays["scale"] = torch.zeros((S,), dtype=torch.float32,
                                           device=self.device)
        # host books: aid -> slot / pins, LRU recency (OrderedDict order)
        # and the packed host copy of each RESIDENT adapter (what a
        # demotion writes, with no device read)
        self._slot_of: Dict[int, int] = {}
        self._pins: Dict[int, int] = {}
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        self._packed: Dict[int, Dict] = {}
        self.loads_total = 0
        self.load_bytes_total = 0
        self.demotions_total = 0
        self.demote_bytes_total = 0
        self.promotions_total = 0
        self.evictions_total = 0
        self.slot_hits_total = 0
        self.fallbacks_total = 0

    # ---- residency queries ----
    def slot_of(self, adapter_id: int) -> int:
        """The slot holding ``adapter_id`` (0 for the base model); valid
        while the adapter is pinned — the engine mirrors it into its
        per-row slot array at seating."""
        aid = int(adapter_id)
        if aid == 0:
            return 0
        slot = self._slot_of.get(aid)
        if slot is None:
            raise KeyError(f"adapter {aid} is not resident")
        return slot

    def resident(self, adapter_id: int) -> bool:
        return int(adapter_id) == 0 or int(adapter_id) in self._slot_of

    def pins(self, adapter_id: int) -> int:
        return self._pins.get(int(adapter_id), 0)

    def validate_id(self, adapter_id: int) -> None:
        """Reject an ``adapter_id`` that no source can resolve (neither
        resident, registered nor in the host store, or over the rank
        bucket) at request intake, instead of at admission inside the
        serving loop. Loads, promotes and pins nothing."""
        aid = int(adapter_id)
        if aid == 0 or aid in self._slot_of:
            return
        src = self.registry.get(aid)
        if src is not None:
            if src["rank"] > self.rank:
                raise ValueError(
                    f"adapter {aid} rank {src['rank']} exceeds the "
                    f"pool's rank bucket {self.rank} — build the pool "
                    f"with rank >= the largest registered adapter")
            return
        if self.store is not None and self.store.contains(
                self._store_key(aid)):
            return
        raise ValueError(
            f"adapter {aid} is neither registered nor present in the "
            f"host store — register it before submitting requests "
            f"that reference it")

    @property
    def used_slots(self) -> int:
        return len(self._slot_of)

    def slot_available(self) -> bool:
        """True when an :meth:`acquire` that needs a NEW slot could
        succeed now: a slot is free or some resident adapter is unpinned
        (the scheduler's feasibility probe; changes nothing)."""
        if self.used_slots < self.slots:
            return True
        return any(self._pins.get(aid, 0) == 0 for aid in self._slot_of)

    # ---- acquire / release (the per-request pin protocol) ----
    def acquire(self, adapter_id: int) -> int:
        """Pin ``adapter_id`` for one running row and return its slot: a
        resident adapter pins in place (a slot hit); another loads into
        a free slot, reclaiming the LRU unpinned one when the pool is
        full. Raises :class:`AdapterPoolExhausted` when every slot is
        pinned and ``KeyError`` when neither the registry nor the store
        knows the adapter. A fault at a load or promote commits
        nothing."""
        aid = int(adapter_id)
        if aid == 0:
            return 0
        if aid in self._slot_of:
            self._pins[aid] = self._pins.get(aid, 0) + 1
            self._lru.move_to_end(aid)
            self.slot_hits_total += 1
            return self._slot_of[aid]
        slot = self._free_slot()
        packed = self._fetch_packed(aid)
        self._install(slot, aid, packed)
        self._pins[aid] = self._pins.get(aid, 0) + 1
        return slot

    def release(self, adapter_id: int) -> None:
        """Drop one pin; the slot stays resident (warm) until LRU reclaim
        needs it. A no-op on the base id and on zero pins."""
        aid = int(adapter_id)
        if aid == 0:
            return
        n = self._pins.get(aid, 0)
        if n > 0:
            self._pins[aid] = n - 1

    def reset_pins(self) -> None:
        """Zero every pin: the supervisor's rebuild hook (recovery
        re-admits every journaled session through :meth:`acquire`)."""
        self._pins = {}

    # ---- slot lifecycle ----
    def _free_slot(self) -> int:
        taken = set(self._slot_of.values())
        for s in range(1, self.slots + 1):
            if s not in taken:
                return s
        # LRU reclaim among unpinned residents, demoting first
        for aid in list(self._lru):
            if self._pins.get(aid, 0) == 0:
                return self._evict(aid)
        raise AdapterPoolExhausted(
            f"all {self.slots} adapter slots are pinned by running "
            f"requests; the admission defers until one retires")

    def _evict(self, aid: int) -> int:
        slot = self._slot_of.pop(aid)
        self._lru.pop(aid, None)
        self._pins.pop(aid, None)
        packed = self._packed.pop(aid, None)
        if self.store is not None and packed is not None:
            entry = self.store.put(
                self._store_key(aid),
                {n: packed[n] for n in FACTOR_NAMES},
                extra={"alpha": packed["alpha"], "rank": packed["rank"],
                       "adapter_id": aid},
                persist=True)
            self.demote_bytes_total += entry["bytes"]
            self.demotions_total += 1
            _obs.serving_adapter_demoted(entry["bytes"])
        self.evictions_total += 1
        # the vacated slot's factors are stale until the next install
        # overwrites the whole slot row; no row gathers a slot the books
        # do not map
        return slot

    @staticmethod
    def _store_key(aid: int) -> bytes:
        # a bytes key: eligible for the store's standing on-disk layer
        return f"adapter/{int(aid)}".encode()

    def _fetch_packed(self, aid: int) -> Dict:
        """``aid``'s packed factors: a host-store promotion first
        (CRC-verified before anything installs; a corrupt payload is
        quarantined and falls back), then a registry load. The fault
        sites fire before any install."""
        if self.store is not None:
            entry = self.store.get(self._store_key(aid))
            if entry is not None:
                try:
                    verify_checksums(entry["arrays"],
                                     entry.get("checksums"),
                                     "adapter_promote")
                    packed = self._decode_entry(entry)
                    fault_point("adapter_promote")
                    self.promotions_total += 1
                    return packed
                except CorruptionDetected:
                    self.store.quarantine(self._store_key(aid),
                                          "adapter_promote")
                    self.fallbacks_total += 1
                    _obs.serving_adapter_fallback("adapter_promote")
        src = self.registry.get(aid)
        if src is None:
            raise KeyError(
                f"adapter {aid} is neither registered nor present in "
                f"the host store — register it before submitting "
                f"requests that reference it")
        if src["rank"] > self.rank:
            raise ValueError(
                f"adapter {aid} rank {src['rank']} exceeds the pool's "
                f"rank bucket {self.rank} — build the pool with rank "
                f">= the largest registered adapter")
        fault_point("adapter_load")
        return {**{n: src[n] for n in FACTOR_NAMES},
                "alpha": src["alpha"], "rank": src["rank"],
                "promoted": False}

    def _decode_entry(self, entry: Dict) -> Dict:
        from .host_tier import HostPageStore
        arrays = HostPageStore.decode(entry)
        want = _factor_shapes(self.cfg, int(entry["extra"]["rank"]))
        for name in FACTOR_NAMES:
            if tuple(arrays[name].shape) != want[name]:
                raise CorruptionDetected(
                    "adapter_promote",
                    f"adapter payload {name} shape "
                    f"{tuple(arrays[name].shape)} != {want[name]}")
        return {**{n: arrays[n].numpy() for n in FACTOR_NAMES},
                "alpha": float(entry["extra"]["alpha"]),
                "rank": int(entry["extra"]["rank"]),
                "promoted": True}

    def _upload(self, a: np.ndarray, dtype) -> torch.Tensor:
        """``a`` cast on the host and sent to the pool's device from
        pinned memory without waiting (the engine's ``_up``); a plain
        copy on the CPU."""
        t = torch.from_numpy(a).to(dtype)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _install(self, slot: int, aid: int, packed: Dict) -> None:
        """Write one adapter's factors into ``slot``, zero-padded to the
        pool rank, and its alpha/r scale, then commit the host books.
        The write covers the whole slot row, so a reclaimed slot's stale
        factors are overwritten."""
        t0 = _obs.generate_begin()
        r = int(packed["rank"])
        nbytes = 0
        host = {}
        for name, shp in _factor_shapes(self.cfg, self.rank).items():
            full = np.zeros(shp, np.float32)
            src = np.asarray(packed[name], np.float32)
            if name in ("aq", "ao"):
                full[:, :, :r] = src
            else:
                full[:, :r, :] = src
            self.arrays[name][:, slot].copy_(self._upload(full, self.dtype))
            host[name] = src
            nbytes += src.nbytes
        scale = np.full((1,), packed["alpha"] / max(r, 1), np.float32)
        self.arrays["scale"][slot:slot + 1].copy_(
            self._upload(scale, torch.float32))
        self._slot_of[aid] = slot
        self._lru[aid] = None
        self._lru.move_to_end(aid)
        self._packed[aid] = {**host, "alpha": float(packed["alpha"]),
                             "rank": r}
        self.loads_total += 1
        self.load_bytes_total += nbytes
        _obs.serving_adapter_load(t0, nbytes,
                                  promoted=bool(packed.get("promoted")))
        self._publish()

    def _publish(self):
        pinned = sum(1 for n in self._pins.values() if n > 0)
        _obs.serving_adapter_slots(self.used_slots, self.slots, pinned)

    def stats(self) -> Dict:
        return {
            "adapter_slots": self.slots,
            "adapter_slots_used": self.used_slots,
            "adapter_rank": self.rank,
            "adapter_loads_total": self.loads_total,
            "adapter_load_bytes_total": self.load_bytes_total,
            "adapter_slot_hits_total": self.slot_hits_total,
            "adapter_evictions_total": self.evictions_total,
            "adapter_demotions_total": self.demotions_total,
            "adapter_demote_bytes_total": self.demote_bytes_total,
            "adapter_promotions_total": self.promotions_total,
            "adapter_fallbacks_total": self.fallbacks_total,
        }
