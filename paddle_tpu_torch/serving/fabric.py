"""Shared content-addressed KV fabric.

The port's counterpart of ``paddle_tpu/serving/fabric.py``. The
standing prefix store (:class:`~.host_tier.HostPageStore`) generalized
into a cluster-wide tier: one fabric server process owns a
``HostPageStore`` (the same LRU RAM bound, the same standing disk layer
with byte-bounded oldest-mtime pruning), and any replica can DEMOTE
payloads to it and PROMOTE payloads from it over the :mod:`.rpc` frame
protocol. The payloads are the host tier's content-addressed byte
conventions, unchanged:

- prefix chains keyed by the raw token bytes of the chain (two replicas
  that prefill the same system prompt address the SAME fabric entry:
  content addressing is what makes the warm start work),
- swap payloads keyed by ``("swap", rid)``,
- adapter factors keyed by ``b"adapter/<id>"``.

:class:`FabricClient` duck-types the ``HostPageStore`` surface the
tiered cache calls (``put`` / ``get`` / ``contains`` / ``pop`` /
``quarantine`` / ``stats``), so attaching a replica to the fabric is
the tiered cache's ``store=`` (:func:`.node.llama_engine` passes it),
and every host-tier path (preemption swap, prefix demote / promote and
write-through, adapter demotion) moves through the cluster tier: a
fresh replica PROMOTES another replica's demoted system prompt instead
of prefilling it cold.

Entries cross the wire as the host tier's ``uint8`` arrays with their
``meta`` (dtype name and shape; bf16 pages included), and either
package's fabric serves the other's clients.

Integrity: entries carry their per-array CRC32s end to end. The server
verifies them before installing a demoted payload; the client verifies
them before returning a promoted payload. A mismatch quarantines the
entry on the server (never served again) and reads as an honest MISS,
so the caller falls back to replay token-identically. Fabric
unavailability degrades the same way: a dead fabric makes every lookup
a miss and every demote a local no-op. The fabric is a cache; losing it
never takes serving down.

Fault sites (fire BEFORE any commit): ``fabric_put`` before a demote
ships, ``fabric_get`` before a promote fetch, and ``fabric_get``'s
TAMPER mode, which flips real payload bytes so that the CHECKSUM path
(not the injector) detects the corruption.

The fabric process is host-only: it never touches the card (its
``ping`` reply says whether this process initialized CUDA, and
:class:`~.multiproc.FabricProcess` starts it with no card visible).
Run a standalone fabric server with::

    python -m paddle_tpu_torch.serving.fabric --dir /path/standing \\
        --page-size 8 --port 0 --port-file /path/fabric.json
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..observability import hooks as _obs
from .host_tier import HostPageStore, _tampered_entry
from .resilience import (CorruptionDetected, fault_point, tamper_point,
                         verify_checksums)
from .rpc import ReplicaUnreachable, RpcClient, RpcServer

# ---------------------------------------------------------------------------
# key / entry wire codecs


def key_to_wire(key) -> Dict:
    """Store key -> JSON-able form. The store's keys are bytes (prefix
    chains, ``b"adapter/..."``), str, int and flat tuples of those
    (``("swap", rid)``)."""
    if isinstance(key, bytes):
        return {"t": "b", "v": key.hex()}
    if isinstance(key, str):
        return {"t": "s", "v": key}
    if isinstance(key, (int, np.integer)):
        return {"t": "i", "v": int(key)}
    if isinstance(key, tuple):
        return {"t": "t", "v": [key_to_wire(k) for k in key]}
    raise ValueError(f"fabric: unencodable store key {key!r}")


def key_from_wire(w: Dict):
    t = w["t"]
    if t == "b":
        return bytes.fromhex(w["v"])
    if t == "s":
        return w["v"]
    if t == "i":
        return int(w["v"])
    return tuple(key_from_wire(k) for k in w["v"])


def entry_to_wire(entry: Dict) -> Tuple[Dict, Dict]:
    """Array-bearing payload dict -> (JSON-able data, blob dict). Generic
    over every payload that follows the raw-``uint8`` + per-array-CRC32
    convention: :meth:`HostPageStore.encode` store entries and
    :meth:`~.paged_cache.PagedKVCache.export_request` handoff payloads.
    The ``arrays`` ride as RPC blobs; the typed ``tensors`` a port
    entry keeps beside them (the same bytes) stay home; every other key
    is metadata."""
    data = {k: v for k, v in entry.items()
            if k not in ("arrays", "tensors")}
    data["checksums"] = {k: int(v)
                         for k, v in (entry.get("checksums")
                                      or {}).items()}
    return data, dict(entry["arrays"])


def entry_from_wire(data: Dict, blobs: Dict) -> Dict:
    out = dict(data)
    out["arrays"] = dict(blobs)
    return out


# ---------------------------------------------------------------------------
# server


class FabricServer:
    """The fabric process: one :class:`HostPageStore` behind an
    :class:`~.rpc.RpcServer`. All policy (LRU RAM bound, standing disk
    layer, disk pruning, quarantine) is the store's own; this class only
    moves entries on and off the wire and holds inbound payloads to
    their CRCs."""

    def __init__(self, page_size: int,
                 capacity_pages: Optional[int] = None,
                 path: Optional[str] = None,
                 max_disk_bytes: Optional[int] = None,
                 host: str = "127.0.0.1", port: int = 0):
        self.store = HostPageStore(page_size,
                                   capacity_pages=capacity_pages,
                                   path=path,
                                   max_disk_bytes=max_disk_bytes)
        self.rpc = RpcServer(self, host=host, port=port)
        self.quarantined_inbound = 0

    @property
    def port(self) -> int:
        return self.rpc.port

    def start(self) -> "FabricServer":
        self.rpc.start()
        return self

    def serve_forever(self) -> None:
        self.rpc.serve_forever()

    def shutdown(self) -> None:
        self.rpc.shutdown()

    # -- RPC surface ------------------------------------------------

    def rpc_ping(self, data, blobs):
        return {"ok": True, "pid": os.getpid(),
                "page_size": self.store.page_size,
                "cuda_initialized": bool(torch.cuda.is_initialized())}

    def rpc_put(self, data, blobs):
        key = key_from_wire(data["key"])
        entry = entry_from_wire(data, blobs)
        try:
            # a payload corrupted between the client's encode and here
            # must never enter the shared store (the frame CRC guards
            # the hop, the entry CRCs guard end to end)
            verify_checksums(entry["arrays"], entry["checksums"],
                             "fabric_put")
        except CorruptionDetected:
            self.quarantined_inbound += 1
            self.store.quarantined_total += 1
            _obs.serving_integrity("fabric_put", "detected")
            _obs.serving_fabric_quarantine("fabric_put")
            raise
        self.store.put(key, HostPageStore.decode(entry),
                       extra=entry["extra"], persist=entry["persist"])
        return {"ok": True}

    def rpc_get(self, data, blobs):
        entry = self.store.get(key_from_wire(data["key"]),
                               touch=bool(data.get("touch", True)))
        if entry is None:
            return {"hit": False}
        out, oblobs = entry_to_wire(entry)
        out["hit"] = True
        return out, oblobs

    def rpc_contains(self, data, blobs):
        return {"hit": self.store.contains(key_from_wire(data["key"]))}

    def rpc_pop(self, data, blobs):
        return {"hit": self.store.pop(key_from_wire(data["key"]))
                is not None}

    def rpc_quarantine(self, data, blobs):
        self.store.quarantine(key_from_wire(data["key"]),
                              str(data.get("site", "fabric_get")))
        return {"ok": True}

    def rpc_stats(self, data, blobs):
        s = self.store.stats()
        s["quarantined_inbound"] = self.quarantined_inbound
        s["rpc_frames_served"] = self.rpc.frames_served
        return s

    def rpc_shutdown(self, data, blobs):
        # reply first, then close the listener from a fresh thread so the
        # dispatcher is not tearing down the socket it is answering on
        threading.Timer(0.05, self.shutdown).start()
        return {"ok": True}


# ---------------------------------------------------------------------------
# client


class FabricClient:
    """A replica's stub onto the fabric: duck-types the
    :class:`HostPageStore` surface that :class:`~.host_tier.
    TieredKVCache` calls, so a cache built with ``store=client`` routes
    every host-tier demote and promote through the cluster tier.

    Degradation: transport loss (:class:`~.rpc.ReplicaUnreachable`)
    never propagates. A demote becomes a local no-op (the encoded entry
    is still returned, so the caller's accounting holds), a promote or
    probe an honest miss. A CRC mismatch on a promoted payload
    quarantines the entry server-side and also reads as a miss, so
    every corrupt path ends in the tier's replay fallback."""

    def __init__(self, client: RpcClient, page_size: int):
        self._rpc = client
        self.page_size = int(page_size)
        # client-side mirror counters (the server's stats() is one RPC
        # away; these make local assertions and tier_stats cheap)
        self.puts_total = 0
        self.hits_total = 0
        self.misses_total = 0
        self.quarantined_total = 0
        self.unreachable_total = 0
        # the load_stats surface (the scheduler reads these off the host
        # tier as a residency signal): this client's own contribution to
        # the shared store; the cluster-wide figure is one stats() RPC
        # away, too dear for the per-dispatch load snapshot
        self.pages_resident = 0
        self.bytes_resident = 0

    @classmethod
    def dial(cls, host: str, port: int, *, page_size: int,
             **kw) -> "FabricClient":
        kw.setdefault("label", "fabric")
        return cls(RpcClient.dial(host, port, **kw), page_size)

    def put(self, key, arrays: Dict, extra: Optional[Dict] = None,
            persist: bool = False) -> Dict:
        fault_point("fabric_put")
        entry = HostPageStore.encode(arrays)
        entry["extra"] = dict(extra or {})
        entry["persist"] = bool(persist)
        data, blobs = entry_to_wire(entry)
        data["key"] = key_to_wire(key)
        t0 = _obs.generate_begin()
        try:
            self._rpc.call("put", data, blobs)
            self.puts_total += 1
            self.pages_resident += int(entry["pages"])
            self.bytes_resident += int(entry["bytes"])
            _obs.serving_fabric_demote(t0, entry["bytes"])
        except ReplicaUnreachable:
            self.unreachable_total += 1
        return entry

    def get(self, key, touch: bool = True) -> Optional[Dict]:
        fault_point("fabric_get")
        t0 = _obs.generate_begin()
        try:
            data, blobs = self._rpc.call(
                "get", {"key": key_to_wire(key), "touch": bool(touch)})
        except ReplicaUnreachable:
            self.unreachable_total += 1
            self.misses_total += 1
            _obs.serving_fabric_promote(t0, 0, False)
            return None
        if not data.get("hit"):
            self.misses_total += 1
            _obs.serving_fabric_promote(t0, 0, False)
            return None
        entry = entry_from_wire(data, blobs)
        if tamper_point("fabric_get"):
            # chaos: flip real payload bytes so the CRC check below is
            # what detects the corruption
            entry = _tampered_entry(entry)
        try:
            # verified BEFORE the entry reaches any install path: a
            # corrupt fabric payload reads as a miss, never as bytes
            verify_checksums(entry["arrays"], entry["checksums"],
                             "fabric_get")
        except CorruptionDetected:
            self.quarantined_total += 1
            _obs.serving_integrity("fabric_get", "detected")
            _obs.serving_fabric_quarantine("fabric_get")
            self.quarantine(key, "fabric_get", _local=False)
            self.misses_total += 1
            _obs.serving_fabric_promote(t0, 0, False)
            return None
        self.hits_total += 1
        _obs.serving_fabric_promote(t0, entry["bytes"], True)
        return entry

    def contains(self, key) -> bool:
        try:
            data, _ = self._rpc.call("contains",
                                     {"key": key_to_wire(key)})
            return bool(data.get("hit"))
        except ReplicaUnreachable:
            self.unreachable_total += 1
            return False

    def __contains__(self, key) -> bool:
        return self.contains(key)

    def pop(self, key) -> Optional[Dict]:
        """Drop ``key`` fabric-side. Returns None: the tiered cache's
        call sites discard the popped entry, and shipping it back would
        move bytes nothing reads."""
        try:
            self._rpc.call("pop", {"key": key_to_wire(key)})
        except ReplicaUnreachable:
            self.unreachable_total += 1
        return None

    def quarantine(self, key, site: str, _local: bool = True) -> None:
        if _local:
            self.quarantined_total += 1
            _obs.serving_fabric_quarantine(site)
        try:
            self._rpc.call("quarantine",
                           {"key": key_to_wire(key), "site": site})
        except ReplicaUnreachable:
            self.unreachable_total += 1

    def stats(self) -> Dict:
        """Server-side store stats (one RPC), falling back to the
        client-side mirror when the fabric is unreachable."""
        try:
            data, _ = self._rpc.call("stats", {})
            data["client_hits_total"] = self.hits_total
            data["client_misses_total"] = self.misses_total
            data["client_unreachable_total"] = self.unreachable_total
            return data
        except ReplicaUnreachable:
            self.unreachable_total += 1
            return {"entries": -1, "pages_resident": 0,
                    "bytes_resident": 0, "capacity_pages": None,
                    "puts_total": self.puts_total,
                    "hits_total": self.hits_total,
                    "misses_total": self.misses_total,
                    "capacity_drops_total": 0,
                    "quarantined_total": self.quarantined_total,
                    "disk_pruned_total": 0,
                    "disk_pruned_bytes_total": 0,
                    "client_unreachable_total": self.unreachable_total}

    def close(self) -> None:
        self._rpc.close()


# ---------------------------------------------------------------------------
# worker-process entry


def write_endpoint_file(path: str, port: int) -> None:
    """Atomic ``{"port", "pid"}`` handshake file: the parent polls for
    it to learn the bound port (binding port 0 dodges races)."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"port": int(port), "pid": os.getpid()}, f)
    os.replace(tmp, path)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="paddle_tpu_torch shared KV fabric server")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--page-size", type=int, default=8)
    p.add_argument("--capacity-pages", type=int, default=None)
    p.add_argument("--dir", default=None,
                   help="standing disk layer directory")
    p.add_argument("--max-disk-bytes", type=int, default=None)
    p.add_argument("--port-file", default=None,
                   help="write a {port, pid} JSON handshake here once "
                        "the listener is bound")
    args = p.parse_args(argv)
    srv = FabricServer(args.page_size,
                       capacity_pages=args.capacity_pages,
                       path=args.dir, max_disk_bytes=args.max_disk_bytes,
                       host=args.host, port=args.port)
    if args.port_file:
        write_endpoint_file(args.port_file, srv.port)
    srv.serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
