"""Replica worker process for the multi-process serving cluster.

The port's counterpart of ``paddle_tpu/serving/node.py``. One
:class:`ReplicaNode` process = one :class:`~.resilience.
EngineSupervisor` (engine + scheduler + journal) behind an
:class:`~.rpc.RpcServer`. The RPC surface is the cluster control
plane's replica vocabulary (``submit_request`` / ``step`` /
``load_stats`` / the handoff export, adopt and finish triplet /
``drain``), so :class:`~.multiproc.MultiProcessCluster` re-hosts the
in-process :class:`~.cluster.ServingCluster` logic over stubs without
changing it.

Durable process identity: each node owns a per-replica WAL directory.
``kill -9`` the process and start a replacement with ``recover: true``
on the same directory: it rebuilds through
:meth:`EngineSupervisor.recover_from_disk` (torn tail truncated,
checkpoint + log-suffix replay) and reports the recovered session
records in its hello, so the controller re-anchors its handles and the
replay continues token-identically.

Request state crosses the wire as the journal's own record shape
(:meth:`~.resilience.JournalEntry.as_record` /
``_session_from_record``): the records that make sessions durable on
disk make them portable between processes. Token updates ship as
per-request APPEND deltas, so a step reply is a few ints per live
request, not the whole transcript.

The shared KV fabric (:mod:`.fabric`) attaches at engine-factory level:
the node dials a :class:`~.fabric.FabricClient` and the factory gives
it to the tiered cache as its host store, so every rebuild of the
engine, post-crash recovery included, is fabric-warm.

The engine factory is :func:`llama_engine` (the reference's
``tiny_llama_engine`` draws its weights from ``jax.random.key(seed)``
in every process). Its weights come from a seeded ``torch.Generator``
on the engine's device (:func:`~..models.llama.init_params`), which
gives every process bit-identical weights without shipping them, or
from ``params_path``, an ``.npz`` of a weight pytree's leaves (the CPU
tests carry the JAX package's tiny weights into their workers this
way). The engine runs on ``device`` (default the card; a worker asked
for the card on a machine without one raises, and the controller
reports the worker's log). The reference spec's ``xla_cache_dir`` (a
compilation cache for JAX workers) has no counterpart here and is not
read.

Each node also reports its process's kernel launch counts (the
wrappers' ``.launches``) in its ``ping`` reply, and can zero them
(``reset_launches``): the counters live in the worker process.

Run a worker with::

    python -m paddle_tpu_torch.serving.node --spec /path/spec.json

where the spec file holds the JSON :class:`ReplicaNode` spec (engine
factory + knobs, WAL dir, fabric endpoint, trace / metrics flags,
``port_file`` handshake path).
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from ..observability import hooks as _obs
from .fabric import (FabricClient, entry_from_wire, entry_to_wire,
                     write_endpoint_file)
from .resilience import EngineSupervisor, _session_from_record
from .rpc import RpcServer

# ---------------------------------------------------------------------------
# request records on the wire


def request_record(req, now: Optional[float] = None,
                   admitted: bool = False) -> Dict:
    """Controller-side record builder: the
    :meth:`~.resilience.JournalEntry.as_record` shape, made from a bare
    request handle (the multi-process controller holds no engine,
    journal or clock epoch shared with the node, so deadlines ship as
    REMAINING seconds, as drain records do). ``admitted=True`` marks a
    rehomed in-flight session, which the node-side rebuild resumes
    with the preempted replay semantics."""
    remaining = None
    if req.deadline_at is not None and now is not None:
        remaining = float(req.deadline_at - now)
    eos = req.eos_token_id
    return {"rid": int(req.rid),
            "prompt": np.asarray(req.prompt).reshape(-1).tolist(),
            "max_new_tokens": int(req.max_new_tokens),
            "eos_token_id": None if eos is None else int(eos),
            "priority": int(req.priority),
            "deadline_remaining_s": remaining,
            "tokens": [int(t) for t in req.tokens],
            "admitted": bool(admitted),
            "preemptions": int(req.preemptions),
            "swapped": bool(getattr(req, "swapped", False)),
            "adapter_id": int(getattr(req, "adapter_id", 0)),
            "constraint": None}


# ---------------------------------------------------------------------------
# default engine factory


def load_params_npz(path: str) -> Dict:
    """An ``.npz`` of a weight pytree's leaves, keyed by their
    ``/``-joined paths (``"embed"``, ``"layers/wq"``), back to the
    nested dict of numpy arrays."""
    tree: Dict = {}
    with np.load(path) as z:
        for name in z.files:
            *outer, leaf = name.split("/")
            d = tree
            for k in outer:
                d = d.setdefault(k, {})
            d[leaf] = z[name]
    return tree


def save_params_npz(path: str, tree: Dict) -> None:
    """Write a nested dict of numpy arrays as :func:`load_params_npz`
    reads it."""
    flat = {}

    def walk(prefix, d):
        for k, v in d.items():
            if isinstance(v, dict):
                walk(prefix + k + "/", v)
            else:
                flat[prefix + k] = np.asarray(v)
    walk("", tree)
    np.savez(path, **flat)


def llama_engine(config: str = "tiny", num_layers: int = 2,
                 max_seq_len: Optional[int] = None,
                 device: Optional[str] = None,
                 params_path: Optional[str] = None, seed: int = 0,
                 kv_cache_dtype: Optional[str] = None,
                 host_tier: Optional[bool] = None,
                 host_capacity_pages: Optional[int] = None,
                 store=None, **engine_kw):
    """Factory BUILDER for a Llama paged engine: returns the zero-arg
    ``engine_factory`` the supervisor calls at construction and after
    every teardown. ``config`` names a
    :class:`~..models.llama.LlamaConfig` preset (``"tiny"``, at
    ``max_seq_len`` 64 unless given, or ``"llama2_7b"``) at
    ``num_layers``. The weights are built once per process: from
    ``params_path`` (:func:`load_params_npz`) or else from ``seed``
    through a ``torch.Generator`` on ``device`` (default the card;
    ``"cpu"`` on request), so every process builds the same bits. ``store`` (a dialed
    :class:`~.fabric.FabricClient`) routes the host tier through the
    shared fabric."""
    import torch

    from ..device import resolve_device
    from ..inference.predictor import ContinuousBatchingEngine
    from ..models import llama
    from ..models.convert import params_from_jax

    ckw = {"num_layers": int(num_layers)}
    if config == "tiny":
        ckw["max_seq_len"] = 64 if max_seq_len is None else max_seq_len
    elif max_seq_len is not None:
        ckw["max_seq_len"] = max_seq_len
    cfg = getattr(llama.LlamaConfig, config)(**ckw)
    dev = resolve_device(device)
    if params_path is not None:
        params = params_from_jax(load_params_npz(params_path), dev)
    else:
        params = llama.init_params(
            cfg, torch.Generator(device=dev).manual_seed(int(seed)),
            device=dev)
    engine_kw.setdefault("max_batch", 2)
    engine_kw.setdefault("page_size", 8)
    engine_kw.setdefault("max_len", 32)
    engine_kw.setdefault("prefill_chunk", 8)
    tiered = host_tier if host_tier is not None else store is not None
    hkw: Dict = {}
    if host_capacity_pages is not None:
        hkw["host_capacity_pages"] = host_capacity_pages
    if store is not None:
        hkw["store"] = store

    def make():
        return ContinuousBatchingEngine(
            params, cfg, kv_cache_dtype=kv_cache_dtype,
            host_tier=tiered, host_tier_kw=hkw or None, device=dev,
            **engine_kw)
    return make


#: frames from this size up land in pinned host memory in a process that
#: works on the card
_PINNED_FRAME_BYTES = 1 << 20


def frame_buffer(n: int):
    """The buffer a received frame of ``n`` bytes lands in: in a process
    that works on the card a large one goes to pinned host memory
    (PyTorch's caching host allocator, which reuses freed blocks), so
    the KV pages it carries go up to the card without another copy;
    elsewhere a ``bytearray``."""
    import torch
    if n < _PINNED_FRAME_BYTES or not torch.cuda.is_initialized():
        return bytearray(n)
    return torch.empty(n, dtype=torch.uint8, pin_memory=True).numpy()


def _resolve_factory(spec: Dict, store):
    """``"module:attr"`` factory-builder resolution; the builder gets
    ``factory_kw`` (plus the fabric ``store`` when the node dialed one)
    and returns the supervisor's zero-arg engine factory."""
    name = spec.get("factory") or \
        "paddle_tpu_torch.serving.node:llama_engine"
    mod, _, attr = name.partition(":")
    builder = getattr(importlib.import_module(mod), attr)
    kw = dict(spec.get("factory_kw") or {})
    if store is not None:
        kw["store"] = store
    return builder(**kw)


def wait_endpoint(path: str, timeout_s: float = 60.0,
                  process=None, log: Optional[str] = None) -> Dict:
    """Poll for a worker's ``{"port", "pid"}`` handshake file
    (:func:`~.fabric.write_endpoint_file`). Raises if the deadline
    lapses or the subprocess exits first; the error then carries the
    tail of the worker's ``log`` file, where there is one."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if process is not None and process.poll() is not None:
            raise RuntimeError(
                f"worker exited rc={process.returncode} before "
                f"publishing its endpoint ({path})" + _log_tail(log))
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            time.sleep(0.02)
    raise TimeoutError(f"no endpoint handshake at {path} within "
                       f"{timeout_s}s" + _log_tail(log))


def _log_tail(log: Optional[str], nbytes: int = 4000) -> str:
    if not log:
        return ""
    try:
        with open(log, "rb") as f:
            f.seek(0, os.SEEK_END)
            f.seek(max(0, f.tell() - nbytes))
            tail = f.read().decode("utf-8", "replace")
    except OSError:
        return ""
    return f"; the end of its log {log}:\n{tail}"


# ---------------------------------------------------------------------------
# the worker


class ReplicaNode:
    """One replica process: supervisor + scheduler behind RPC.

    Spec keys: ``replica_id``, ``factory`` (``"module:attr"`` builder),
    ``factory_kw``, ``supervisor_kw``, ``wal_dir`` (the durable process
    identity), ``recover`` (rebuild from the WAL dir: the replacement
    after a kill), ``fabric`` (``{"host", "port"}`` of the shared KV
    fabric), ``trace`` (enable the request tracer and ship span
    batches), ``port_file`` (endpoint handshake path)."""

    def __init__(self, spec: Dict):
        self.spec = dict(spec)
        self.replica_id = int(spec.get("replica_id", 0))
        fab = spec.get("fabric")
        self.fabric: Optional[FabricClient] = None
        if fab:
            page = int((spec.get("factory_kw") or {})
                       .get("page_size", 8))
            self.fabric = FabricClient.dial(
                fab["host"], int(fab["port"]), page_size=page,
                alloc=frame_buffer)
        t0 = time.perf_counter()
        build = _resolve_factory(spec, self.fabric)
        #: host ms of the engine factory's setup (the weights, and with
        #: them this process's first work on the card)
        self.weights_ms = (time.perf_counter() - t0) * 1e3
        # the forwards counters of every engine this process built (a
        # recovery rebuilds the engine; the counters are kept, not the
        # engines, whose pools must be freed)
        self._forwards: List[Dict[str, int]] = []

        def factory():
            eng = build()
            self._forwards.append(eng.forwards)
            return eng
        skw = dict(spec.get("supervisor_kw") or {})
        wal_dir = spec.get("wal_dir")
        recover = bool(spec.get("recover")) and wal_dir \
            and os.path.isdir(wal_dir) and os.listdir(wal_dir)
        t0 = time.perf_counter()
        if recover:
            self.sup = EngineSupervisor.recover_from_disk(
                factory, wal_dir, **skw)
        else:
            self.sup = EngineSupervisor(factory, wal_dir=wal_dir,
                                        **skw)
        #: host ms of the supervisor's construction (its engine build,
        #: and with ``recover`` the WAL scan and reinstall)
        self.build_ms = (time.perf_counter() - t0) * 1e3
        self.sup.replica_id = self.replica_id
        # live handles this node owns; cursors mark the token count and
        # span count the controller has already received
        self._reqs: Dict[int, object] = {}
        self._cursor: Dict[int, int] = {}
        self._spans: Dict[int, int] = {}
        for rid in sorted(getattr(self.sup, "restored", {})):
            self._track(self.sup.restored[rid])
        self.rpc = RpcServer(self, host=spec.get("host", "127.0.0.1"),
                             port=int(spec.get("port", 0)),
                             alloc=frame_buffer)

    def _track(self, req) -> None:
        self._reqs[req.rid] = req
        self._cursor[req.rid] = len(req.tokens)
        self._spans[req.rid] = 0

    def _untrack(self, rid: int) -> None:
        self._reqs.pop(rid, None)
        self._cursor.pop(rid, None)
        self._spans.pop(rid, None)

    # ---- lifecycle ------------------------------------------------

    @property
    def port(self) -> int:
        return self.rpc.port

    def serve_forever(self) -> None:
        if self.spec.get("port_file"):
            write_endpoint_file(self.spec["port_file"], self.port)
        self.rpc.serve_forever()

    def start(self) -> "ReplicaNode":
        self.rpc.start()
        return self

    def shutdown(self) -> None:
        self.rpc.shutdown()
        if self.fabric is not None:
            self.fabric.close()

    # ---- RPC surface ----------------------------------------------

    def rpc_hello(self, data, blobs):
        """Identity + recovery manifest: the records of every session the
        WAL scan requeued (the controller re-anchors its handles to
        these and lets the deterministic replay re-produce any
        group-commit-lagged tokens)."""
        now = self.sup.clock()
        recovered = [e.as_record(now, None)
                     for e in self.sup.journal.live_entries()] \
            if getattr(self.sup, "restored", None) else []
        return {"replica_id": self.replica_id, "pid": os.getpid(),
                "page_size": int(self.sup.engine.cache.page_size),
                "health": self.sup.health,
                "weights_ms": self.weights_ms,
                "build_ms": self.build_ms,
                "recovered": recovered}

    def rpc_submit_request(self, data, blobs):
        """Journaled intake of a request record: fresh dispatch and
        failover rehome alike (``admitted`` in the record selects the
        preempted-resume rebuild, as recovery does)."""
        rec = data["record"]
        req = _session_from_record(self.sup, rec, None)
        if data.get("trace") is not None:
            _obs.serving_trace_submit(req, replica=self.replica_id)
        self.sup.submit_request(req)
        if not req.done:
            self._track(req)
        return {"done": bool(req.done),
                "finish_reason": req.finish_reason}

    def rpc_step(self, data, blobs):
        """One supervised scheduler step; the reply carries per-request
        token APPEND deltas past each controller cursor, final done /
        finish states, and (with tracing on) the span dicts recorded
        since the last ship (the cross-process stitch)."""
        has_work = self.sup.step()
        updates: List[Dict] = []
        spans: List[Dict] = []
        finished: List[int] = []
        for rid, req in self._reqs.items():
            cur = self._cursor[rid]
            if len(req.tokens) < cur:
                # a recovery rewound committed-but-unsynced tokens;
                # resync the controller with a full replacement
                updates.append({"rid": rid, "reset": True,
                                "tokens": [int(t) for t in req.tokens],
                                "done": bool(req.done),
                                "finish_reason": req.finish_reason})
                self._cursor[rid] = len(req.tokens)
            elif len(req.tokens) > cur or req.done:
                updates.append(
                    {"rid": rid,
                     "tokens": [int(t) for t in req.tokens[cur:]],
                     "done": bool(req.done),
                     "finish_reason": req.finish_reason})
                self._cursor[rid] = len(req.tokens)
            tr = getattr(req, "trace", None)
            if tr is not None:
                all_spans = list(tr.spans)
                seen = self._spans.get(rid, 0)
                if len(all_spans) < seen:        # ring wrapped
                    seen = 0
                for s in all_spans[seen:]:
                    d = s.to_dict()
                    d["rid"] = rid
                    spans.append(d)
                self._spans[rid] = len(all_spans)
            if req.done:
                finished.append(rid)
        for rid in finished:
            self._untrack(rid)
        return {"has_work": bool(has_work), "health": self.sup.health,
                "updates": updates, "spans": spans}

    def rpc_load_stats(self, data, blobs):
        return self.sup.load_stats()

    def rpc_handoff_ready(self, data, blobs):
        """Rids whose prefill completed and whose slot is not mid-chunk:
        the prefill side of the harvest scan."""
        eng = self.sup.engine
        rids = [int(r.rid) for r in eng.running_requests()
                if not r.done and r.tokens
                and r.slot not in eng._pending
                and r.rid in self._reqs]
        return {"rids": rids}

    def rpc_export_prefilled(self, data, blobs):
        """Pure-read export of a running slot's live pages; the KV entry
        rides as blobs. The reply also carries the node's CURRENT token
        list: the adopt record must be built from the exporter's exact
        state, not the controller's possibly older view."""
        req = self._reqs[int(data["rid"])]
        payload = self.sup.engine.export_prefilled(req, with_kv=True)
        out = {"slot": int(payload["slot"]),
               "length": int(payload["length"]),
               "last": int(payload["last"]),
               "tokens": [int(t) for t in req.tokens]}
        kv_data, oblobs = entry_to_wire(payload["kv"])
        out["kv"] = kv_data
        return out, oblobs

    def rpc_adopt_prefilled(self, data, blobs):
        """Decode-side import + journal adoption in ONE exchange: rebuild
        a clean handle from the record, install the shipped pages
        (CRC-verified before any scatter: a corrupt payload raises
        ``CorruptionDetected`` as a typed envelope and commits
        nothing), then ``adopt_running``. ``ok=False`` means no free
        slot: the controller offers the payload elsewhere."""
        rec = dict(data["record"])
        rec["admitted"] = False     # adopt_running journals admission
        req = _session_from_record(self.sup, rec, None)
        # node-local trace so decode-side spans record here and ship to
        # the controller's stitched trace
        _obs.serving_trace_submit(req, replica=self.replica_id)
        payload = {"rid": int(rec["rid"]), "slot": int(data["slot"]),
                   "length": int(data["length"]),
                   "last": int(data["last"]),
                   "kv": entry_from_wire(data["kv"], blobs)}
        if not self.sup.engine.import_prefilled(req, payload):
            return {"ok": False}
        self.sup.adopt_running(req)
        self._track(req)
        return {"ok": True, "slot": int(req.slot)}

    def rpc_finish_handoff(self, data, blobs):
        """Prefill-side detach after a successful adopt elsewhere: the
        durable journal tombstone first, then slot clear + page release
        (the clear-before-release order the in-process handoff relies
        on)."""
        rid = int(data["rid"])
        req = self._reqs.get(rid)
        if req is None:
            return {"ok": False}
        self.sup.journal.forget(rid)
        self.sup.engine.finish_handoff(req, int(data["slot"]))
        self._untrack(rid)
        return {"ok": True}

    def rpc_forget(self, data, blobs):
        """Durably drop a session this node must NOT serve (the
        controller's post-recovery dedupe: the handle already finished
        elsewhere, or a rehomed copy supersedes this one)."""
        rid = int(data["rid"])
        req = self._reqs.get(rid)
        self.sup.journal.forget(rid)
        if req is not None:
            try:
                self.sup.engine.cancel_request(req, "superseded")
            except Exception:  # noqa: BLE001 - already gone is fine
                pass
            self._untrack(rid)
        return {"ok": True}

    def rpc_drain(self, data, blobs):
        """Retirement: checkpoint to ``path`` and hand back the live
        session records for the controller to rehome. Drain FIRST: it
        commits any in-flight overlapped step and syncs the journal, so
        the records carry every token the card already produced."""
        summary = self.sup.drain(data["path"])
        now = self.sup.clock()
        summary["records"] = [e.as_record(now, None)
                              for e in self.sup.journal.live_entries()]
        return summary

    def rpc_tier_stats(self, data, blobs):
        cache = self.sup.engine.cache
        out = {"tier": cache.tier_stats()
               if hasattr(cache, "tier_stats") else {}}
        alloc = cache.allocator
        if data.get("drop_prefix") and cache.prefix is not None:
            # the balanced-allocator gate: standing prefix-trie pages are
            # resident on purpose; release them so num_used == 0 can be
            # asserted after a drain
            cache.prefix.drop_all(alloc)
        out["allocator"] = alloc.stats()
        # host seconds of page installs by part (read, pin, copy)
        out["scatter_host_s"] = dict(cache.scatter_host_s)
        if self.fabric is not None:
            out["fabric_client"] = {
                "puts_total": self.fabric.puts_total,
                "hits_total": self.fabric.hits_total,
                "misses_total": self.fabric.misses_total,
                "quarantined_total": self.fabric.quarantined_total,
                "unreachable_total": self.fabric.unreachable_total}
        return out

    def rpc_ping(self, data, blobs):
        """Liveness, plus this process's kernel launch counts and the
        forwards counted by every engine it built (the card check holds
        one to the other)."""
        from ..ops import kernels
        forwards: Dict[str, int] = {}
        for fw in self._forwards:
            for k, v in fw.items():
                forwards[k] = forwards.get(k, 0) + v
        return {"ok": True, "pid": os.getpid(),
                "health": self.sup.health,
                "launches": kernels.launch_counts(),
                "forwards": forwards,
                "rpc": {"frames_served": self.rpc.frames_served,
                        "deduped_replies": self.rpc.deduped_replies,
                        "corrupt_frames": self.rpc.corrupt_frames,
                        "served_ms": {m: ns / 1e6 for m, ns in
                                      self.rpc.served_ns.items()}}}

    def rpc_metrics(self, data, blobs):
        """This process's metrics registry (``metrics: true`` in the
        spec turns emission on)."""
        from ..observability import metrics
        return metrics.REGISTRY.to_json()

    def rpc_reset_launches(self, data, blobs):
        """Zero this process's launch counts and its engines' forwards."""
        from ..ops import kernels
        kernels.reset_launch_counts()
        for fw in self._forwards:
            for k in fw:
                fw[k] = 0
        return {"ok": True}

    def rpc_shutdown(self, data, blobs):
        threading.Timer(0.05, self.shutdown).start()
        return {"ok": True}


# ---------------------------------------------------------------------------
# worker-process entry


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="paddle_tpu_torch serving replica worker")
    p.add_argument("--spec", required=True,
                   help="path to the JSON ReplicaNode spec")
    args = p.parse_args(argv)
    with open(args.spec) as f:
        spec = json.load(f)
    if spec.get("trace"):
        from ..observability import tracing
        tracing.enable()
    if spec.get("metrics"):
        from .. import observability as obs
        obs.enable()
    node = ReplicaNode(spec)
    node.serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
