"""Multi-process serving cluster: the in-process
:class:`~.cluster.ServingCluster` control plane re-hosted over socket
RPC.

The port's counterpart of ``paddle_tpu/serving/multiproc.py``, line for
line. Process tree::

    controller (this module)
      |-- replica worker 0   python -m paddle_tpu_torch.serving.node
      |-- replica worker 1   (one EngineSupervisor + scheduler each,
      |        ...            per-replica WAL dir = durable identity)
      `-- KV fabric          python -m paddle_tpu_torch.serving.fabric
                             (shared content-addressed page store)

The controller holds NO engine and never touches the card. It mints
bare :class:`~..inference.predictor.GenerationRequest` handles, runs
the unchanged cluster policy (affinity router, fair-share accounts, SLO
admission, autoscaler hysteresis) against ``load_stats`` dicts fetched
over RPC (the router's view was always just those dicts), and mirrors
``ServingCluster.step``'s control flow with RPC stubs where the
in-process cluster held supervisor references. Each worker process
creates its own context on the card (workers are started with
``subprocess``, never forked from a process that holds one); the fabric
process runs with no card visible. The workers step one after another
on the controller's thread, as the in-process replicas do, so the
process boundary buys isolation (``kill -9`` survival), not
throughput.

Request state crosses the wire as journal records; token updates come
back as per-request append deltas; prefill→decode handoffs ship the
exported KV entry as raw blobs through the export → adopt →
finish_handoff triplet, CRC-verified on the decode side before install.

``kill -9`` of a replica process is FAILOVER, not data loss: the
controller detects the dead peer (``ReplicaUnreachable`` after bounded
idempotent retry, or the process found dead between steps), spawns a
replacement on the SAME WAL directory with ``recover: true``,
re-anchors its handles to the recovered session records from the
replacement's hello (greedy replay regenerates any group-commit-lagged
tokens token-identically), durably forgets resurrected sessions that
already finished, and rehomes sessions the torn WAL tail lost. With the
shared fabric attached, the replacement starts WARM: prefix chains its
predecessor demoted promote instead of prefilling cold.

Every process's output goes to a log file in the work directory (a
worker holding the caller's pipes open wedges piped runs), a worker
that dies before its handshake raises with the end of its log, and a
cluster whose construction fails closes what it had started.
"""
from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from collections import deque
from typing import Deque, Dict, List, Optional

from ..observability import hooks as _obs
from ..observability import tracing as _tr
from ..observability.tracing import Span
from .fabric import entry_from_wire, entry_to_wire
from .host_tier import _tampered_entry
from .node import request_record, wait_endpoint
from .paged_cache import PoolExhausted
from .policy import FinishReason, Priority
from .resilience import (CorruptionDetected, EngineDead, InjectedFault,
                         fault_point, tamper_point)
from .router import ClusterRouter
from .rpc import ReplicaUnreachable, RpcClient

#: the directory that holds the ``paddle_tpu_torch`` package: put on the
#: workers' import path, so that they start from any working directory
_PKG_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _child_env(env=None, **extra) -> Dict[str, str]:
    out = dict(os.environ if env is None else env)
    path = out.get("PYTHONPATH")
    out["PYTHONPATH"] = _PKG_PARENT + (os.pathsep + path if path else "")
    out.update(extra)
    return out


def _spawn(argv, log_path: str, env):
    """Start ``argv`` with stdin closed and its output appended to
    ``log_path``."""
    with open(log_path, "ab") as log:
        return subprocess.Popen(argv, env=env, stdin=subprocess.DEVNULL,
                                stdout=log, stderr=subprocess.STDOUT)


# ---------------------------------------------------------------------------
# worker process stubs


class FabricProcess:
    """Spawn and own one ``python -m paddle_tpu_torch.serving.fabric``
    server process (no card visible to it); :attr:`endpoint` is what
    replica specs (and :class:`MultiProcessCluster`) take."""

    def __init__(self, workdir: str, *, page_size: int = 8,
                 capacity_pages: Optional[int] = None,
                 store_dir: Optional[str] = None,
                 spawn_timeout_s: float = 120.0, env=None):
        os.makedirs(workdir, exist_ok=True)
        self.port_file = os.path.join(workdir, "fabric.endpoint")
        self.log = os.path.join(workdir, "fabric.log")
        try:
            os.unlink(self.port_file)
        except OSError:
            pass
        argv = [sys.executable, "-m", "paddle_tpu_torch.serving.fabric",
                "--page-size", str(page_size),
                "--port-file", self.port_file]
        if capacity_pages is not None:
            argv += ["--capacity-pages", str(capacity_pages)]
        if store_dir is not None:
            argv += ["--dir", store_dir]
        self.proc = _spawn(argv, self.log,
                           _child_env(env, CUDA_VISIBLE_DEVICES=""))
        try:
            info = wait_endpoint(self.port_file, spawn_timeout_s,
                                 process=self.proc, log=self.log)
        except BaseException:
            self.kill()
            raise
        self.host, self.port = "127.0.0.1", int(info["port"])
        self.endpoint = {"host": self.host, "port": self.port}

    def client(self, **kw) -> RpcClient:
        kw.setdefault("label", "fabric")
        return RpcClient.dial(self.host, self.port, **kw)

    def alive(self) -> bool:
        return self.proc.poll() is None

    def kill(self) -> None:
        if self.alive():
            self.proc.kill()
        self.proc.wait()

    def close(self) -> None:
        if self.alive():
            try:
                c = self.client(retries=1, timeout_s=5.0)
                c.call("shutdown")
                c.close()
                self.proc.wait(timeout=10)
            except Exception:  # noqa: BLE001 - hard-kill fallback
                pass
        self.kill()


class ReplicaProcess:
    """One spawned replica worker + its dialed RPC stub. ``hello`` is the
    worker's identity and recovery manifest, fetched right after the
    endpoint handshake; ``spawn_ms`` the host milliseconds from the
    process's start to the hello's reply. ``connect=False`` only starts
    the process (:meth:`connect` waits for it later), so that several
    workers start together."""

    def __init__(self, spec: Dict, *, spawn_timeout_s: float = 300.0,
                 rpc_kw: Optional[Dict] = None, env=None,
                 connect: bool = True):
        self.spec = dict(spec)
        self.replica_id = int(spec["replica_id"])
        self.draining = False
        base = os.path.dirname(spec["port_file"])
        os.makedirs(base, exist_ok=True)
        try:
            os.unlink(spec["port_file"])
        except OSError:
            pass
        self.spec_path = os.path.join(
            base, f"replica{self.replica_id:03d}.spec.json")
        self.log = os.path.join(base, f"replica{self.replica_id:03d}.log")
        with open(self.spec_path, "w") as f:
            json.dump(self.spec, f)
        self.client = None
        self._spawn_timeout_s = spawn_timeout_s
        self._rpc_kw = rpc_kw
        self._t0 = time.perf_counter()
        self.proc = _spawn(
            [sys.executable, "-m", "paddle_tpu_torch.serving.node",
             "--spec", self.spec_path], self.log, _child_env(env))
        if connect:
            self.connect()

    def connect(self) -> "ReplicaProcess":
        """Wait for the worker's endpoint, dial it and fetch its hello;
        a worker that dies or times out first is killed and raises."""
        try:
            info = wait_endpoint(self.spec["port_file"],
                                 self._spawn_timeout_s,
                                 process=self.proc, log=self.log)
            kw = dict(self._rpc_kw or {})
            kw.setdefault("label", f"replica{self.replica_id}")
            self.client = RpcClient.dial("127.0.0.1", int(info["port"]),
                                         **kw)
            self.hello, _ = self.client.call("hello")
        except BaseException:
            self.kill()
            raise
        self.spawn_ms = (time.perf_counter() - self._t0) * 1e3
        return self

    def call(self, method: str, data=None, blobs=None, **kw):
        return self.client.call(method, data, blobs, **kw)

    def alive(self) -> bool:
        return self.proc.poll() is None

    def kill(self, sig: int = signal.SIGKILL) -> None:
        """Hard-stop the worker (the chaos gate sends SIGKILL: no atexit,
        no flush, exactly the crash the WAL discipline is for)."""
        if self.alive():
            self.proc.send_signal(sig)
        self.proc.wait()
        if self.client is not None:
            self.client.close()

    def close(self) -> None:
        if self.alive() and self.client is not None:
            try:
                self.call("shutdown", retries=1, timeout_s=5.0)
                self.proc.wait(timeout=10)
            except Exception:  # noqa: BLE001 - hard-kill fallback
                pass
        self.kill()


# ---------------------------------------------------------------------------
# the controller


class MultiProcessCluster:
    """`ServingCluster` semantics across a process tree.

    The public surface matches the in-process cluster where it can:
    :meth:`submit` returns a live request handle that fills in as steps
    run; :meth:`step` / :meth:`run` drive the cluster; the failure
    counters carry the same names. Construction SPAWNS the replica
    workers (and dials the shared fabric when given its endpoint).
    ``factory_kw`` goes to the workers' engine factory
    (:func:`~.node.llama_engine` by default: pass ``device="cpu"`` there
    to run the workers on the CPU)."""

    def __init__(self, *, replicas: int = 1, workdir: str,
                 factory: str =
                 "paddle_tpu_torch.serving.node:llama_engine",
                 factory_kw: Optional[Dict] = None,
                 supervisor_kw: Optional[Dict] = None,
                 prefill_replicas: int = 0,
                 fabric: Optional[Dict] = None,
                 router: Optional[ClusterRouter] = None,
                 quotas: Optional[Dict] = None,
                 admission=None, autoscaler=None,
                 trace: bool = False, metrics: bool = False,
                 clock=time.monotonic,
                 handoff_retries: int = 2, retry_sleep=time.sleep,
                 rpc_kw: Optional[Dict] = None,
                 spawn_timeout_s: float = 300.0, env=None):
        if prefill_replicas >= replicas and replicas > 0 \
                and prefill_replicas > 0:
            raise ValueError("need at least one decode replica")
        self.workdir = workdir
        os.makedirs(workdir, exist_ok=True)
        self.factory = factory
        self.factory_kw = dict(factory_kw or {})
        self.supervisor_kw = dict(supervisor_kw or {})
        self.fabric = fabric
        self.trace = bool(trace)
        self.metrics = bool(metrics)
        self.clock = clock
        self.prefill_replicas = int(prefill_replicas)
        self.handoff_retries = int(handoff_retries)
        self._retry_sleep = retry_sleep
        self._rpc_kw = dict(rpc_kw or {})
        self._spawn_timeout_s = float(spawn_timeout_s)
        self._env = env
        # every worker starts at once; the handshakes are then awaited
        # in turn (a worker's start is mostly its imports and its card)
        self.nodes: List[Optional[ReplicaProcess]] = []
        try:
            for i in range(replicas):
                self.nodes.append(self._spawn_node(i, connect=False))
            for node in self.nodes:
                node.connect()
        except BaseException:
            self.close()
            raise
        pages = {n.hello["page_size"] for n in self.nodes}
        if len(pages) != 1:
            self.close()
            raise ValueError("replica workers disagree on page size: "
                             "handoff and affinity need one geometry")
        page = pages.pop()
        self.router = router if router is not None else ClusterRouter(
            page, quotas=quotas, clock=clock)
        self.admission = admission
        self.autoscaler = autoscaler
        self._next_rid = 0
        self._rq: List[Dict] = []
        self._live: Dict[int, object] = {}  # rid -> GenerationRequest
        self._meta: Dict[int, Dict] = {}
        self._owner: Dict[int, int] = {}
        self._seq = 0
        self._steps = 0
        self._node_busy: Dict[int, bool] = {}
        self.handoffs_total = 0
        self.handoff_retries_total = 0
        self.handoff_corruptions_total = 0
        self.autoscale_faults_total = 0
        self.failovers_total = 0
        self.retirements_total = 0
        self.deadline_cancels_total = 0

    # ---- process management ----

    def _replica_wal_dir(self, idx: int) -> str:
        return os.path.join(self.workdir, "wal", f"replica{idx:03d}")

    def _node_spec(self, idx: int, recover: bool) -> Dict:
        return {"replica_id": idx,
                "factory": self.factory,
                "factory_kw": self.factory_kw,
                "supervisor_kw": self.supervisor_kw,
                "wal_dir": self._replica_wal_dir(idx),
                "recover": bool(recover),
                "fabric": self.fabric,
                "trace": self.trace,
                "metrics": self.metrics,
                "port_file": os.path.join(
                    self.workdir, f"replica{idx:03d}.endpoint")}

    def _spawn_node(self, idx: int, recover: bool = False,
                    connect: bool = True) -> ReplicaProcess:
        return ReplicaProcess(self._node_spec(idx, recover),
                              spawn_timeout_s=self._spawn_timeout_s,
                              rpc_kw=self._rpc_kw, env=self._env,
                              connect=connect)

    def close(self) -> None:
        """Graceful teardown of the worker tree (the fabric, when the
        caller spawned one, is the caller's to close)."""
        for node in self.nodes:
            if node is not None:
                node.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # ---- roles / loads ----

    def _prefill_idxs(self) -> List[int]:
        return list(range(self.prefill_replicas))

    def _decode_idxs(self) -> List[int]:
        return list(range(self.prefill_replicas, len(self.nodes)))

    def _serviceable(self, idx: int) -> bool:
        node = self.nodes[idx]
        return node is not None and not node.draining and node.alive()

    def _alive(self, idxs) -> Dict[int, Dict]:
        """``load_stats`` snapshots over RPC, still the router's whole
        view. A peer that went unreachable mid-snapshot fails over here
        and drops out of this round's loads."""
        out = {}
        for i in list(idxs):
            if not self._serviceable(i):
                continue
            try:
                out[i], _ = self.nodes[i].call("load_stats")
            except ReplicaUnreachable:
                self._failover(i)
            except EngineDead:
                self._failover(i)
        return out

    # ---- intake ----

    def submit(self, prompt, max_new_tokens: int = 16, *,
               tenant: str = "default", priority=Priority.NORMAL,
               deadline_s: Optional[float] = None, eos_token_id=None,
               adapter_id: int = 0):
        """Queue a prompt for routed dispatch: the controller mints the
        cluster-unique rid itself (no engine involved) and the handle
        fills in from step-reply deltas. Grammar-constrained requests
        are not supported across the process boundary."""
        # deferred: the engine module imports serving.resilience at
        # module load, so a top-level import here would be circular
        from ..inference.predictor import GenerationRequest
        rid = self._next_rid
        self._next_rid += 1
        req = GenerationRequest(rid, prompt, max_new_tokens,
                                eos_token_id)
        req.priority = int(priority)
        req.adapter_id = int(adapter_id)
        cost = req.prompt.shape[1] + req.max_new_tokens
        self._live[rid] = req
        self._meta[rid] = {"tenant": tenant, "cost": cost}
        _obs.serving_trace_submit(req)
        if not self.router.admit_rate_limit(tenant, cost):
            req.done = True
            req.finish_reason = FinishReason.REJECTED_RATELIMIT.value
            self.router.note_ratelimited(tenant)
            _obs.serving_cancelled(1, req.finish_reason)
            _obs.serving_trace_finish(req, req.finish_reason)
            return req
        if deadline_s is not None and self.admission is not None:
            if self.admission.tokens_per_s is not None:
                role = (self._prefill_idxs() if self.prefill_replicas
                        else self._decode_idxs())
                loads = (self._alive(role) or self._alive(
                    range(len(self.nodes)))).values()
            else:
                loads = ()
            if not self.admission.feasible(
                    float(deadline_s), req.prompt.shape[1], loads):
                req.done = True
                req.finish_reason = \
                    FinishReason.REJECTED_INFEASIBLE.value
                self.router.note_slo_rejected(tenant)
                _obs.serving_cancelled(1, req.finish_reason)
                _obs.serving_trace_finish(req, req.finish_reason)
                return req
        if deadline_s is not None:
            req.deadline_at = self.clock() + float(deadline_s)
        _obs.serving_trace_enqueued(req)
        self._rq.append({"req": req, "tenant": tenant, "cost": cost,
                         "seq": self._seq})
        self._seq += 1
        return req

    # ---- dispatch (fair-share order, unchanged policy) ----

    def _dispatch(self):
        if not self._rq:
            return
        now = self.clock()
        by_tenant: Dict[str, Deque] = {}
        for e in self._rq:
            by_tenant.setdefault(e["tenant"], deque()).append(e)
        self._rq = []
        accounts = self.router.accounts
        while by_tenant:
            tenant = min(by_tenant,
                         key=lambda t: (accounts.get(t, 0),
                                        by_tenant[t][0]["seq"]))
            q = by_tenant[tenant]
            e = q.popleft()
            if not q:
                del by_tenant[tenant]
            req = e["req"]
            if req.done:
                continue
            if req.deadline_at is not None and now >= req.deadline_at:
                req.done = True
                req.finish_reason = FinishReason.DEADLINE_EXCEEDED.value
                self.deadline_cancels_total += 1
                _obs.serving_cancelled(1, req.finish_reason)
                _obs.serving_trace_finish(req, req.finish_reason)
                continue
            self._dispatch_one(e)

    def _submit_to(self, idx: int, req, *,
                   admitted: bool = False) -> bool:
        """Journaled intake over the wire; applies the node's verdict
        (shed, immediate finish) to the controller handle. False means
        the peer died mid-dispatch (already failed over): the caller
        requeues."""
        rec = request_record(req, now=self.clock(), admitted=admitted)
        try:
            reply, _ = self.nodes[idx].call(
                "submit_request",
                {"record": rec, "trace": True if self.trace else None})
        except (ReplicaUnreachable, EngineDead):
            self._failover(idx)
            return False
        if reply["done"]:
            req.done = True
            req.finish_reason = reply["finish_reason"]
        return True

    def _dispatch_one(self, entry: Dict):
        req = entry["req"]
        tenant = entry["tenant"]
        fresh = not req.tokens and req.preemptions == 0
        role = (self._prefill_idxs()
                if self.prefill_replicas and fresh
                else self._decode_idxs())
        loads = self._alive(role) or self._alive(
            range(len(self.nodes)))
        if not loads:
            self._rq.append(entry)      # whole fleet mid-failover:
            return                      # redispatch next step
        key = self.router.affinity_key(req.prompt[0])
        akey = self.router.adapter_key(getattr(req, "adapter_id", 0))
        idx, hit = self.router.pick_replica(key, loads,
                                            adapter_key=akey)
        _obs.serving_trace_mark(req, "dispatch", replica=idx,
                                meta={"affinity_hit": bool(hit),
                                      "tenant": tenant})
        admitted = bool(req.tokens) or req.preemptions > 0
        if not self._submit_to(idx, req, admitted=admitted):
            self._rq.append(entry)
            return
        self.router.note_dispatch(idx, hit, tenant)
        self._owner[req.rid] = idx

        def shed():
            return (req.done and req.finish_reason
                    == FinishReason.REJECTED_OVERLOAD.value)
        tried = {idx}
        attempts = 0
        while (shed() and len(loads) > len(tried)
               and self.router.may_retry(tenant, attempts)):
            self.router.note_retry(tenant)
            attempts += 1
            req.done = False
            req.finish_reason = None
            idx2, _ = self.router.pick_replica(None, loads,
                                               exclude=tried)
            _obs.serving_trace_mark(req, "dispatch_retry",
                                    replica=idx2)
            tried.add(idx2)
            if not self._submit_to(idx2, req, admitted=admitted):
                continue
            self.router.note_dispatch(idx2, False, tenant)
            self._owner[req.rid] = idx2
        if shed():
            req.finish_reason = FinishReason.REJECTED_OVERLOAD.value
            if attempts > 0 or (len(loads) > len(tried)
                                and not self.router.may_retry(
                                    tenant, attempts)):
                self.router.note_retry_exhausted()
        else:
            self.router.charge(tenant, entry["cost"])

    # ---- stepping ----

    def step(self) -> bool:
        """One cluster step, the in-process shape with RPC stubs:
        dispatch the router queue, step every serviceable worker and
        fold its token and span deltas into the controller handles (an
        unreachable or circuit-open worker fails over in place),
        harvest completed prefills across the wire, tick the
        autoscaler, publish gauges."""
        self._dispatch()
        for i in range(len(self.nodes)):
            if not self._serviceable(i):
                if self.nodes[i] is not None \
                        and not self.nodes[i].draining \
                        and self._owned_live(i):
                    # the process died between steps (kill -9): its
                    # sessions are waiting; fail over NOW, not on the
                    # next RPC
                    self._failover(i)
                continue
            try:
                reply, _ = self.nodes[i].call("step")
            except (ReplicaUnreachable, EngineDead):
                self._failover(i)
                continue
            self._node_busy[i] = bool(reply["has_work"])
            self._apply_updates(i, reply)
        if self.prefill_replicas:
            self._harvest_handoffs()
        self._autoscale_tick()
        self._publish()
        self._prune_finished()
        self._steps += 1
        return self._has_work()

    def run(self, max_steps: Optional[int] = None) -> None:
        n = 0
        while self.step():
            n += 1
            if max_steps is not None and n >= max_steps:
                raise RuntimeError(
                    f"cluster still busy after {n} steps")

    def _owned_live(self, idx: int) -> List[int]:
        return [rid for rid, o in self._owner.items()
                if o == idx and rid in self._live]

    def _apply_updates(self, idx: int, reply: Dict) -> None:
        for u in reply.get("updates", ()):
            rid = int(u["rid"])
            if self._owner.get(rid) != idx:
                continue            # stale delta from a pre-handoff
            req = self._live.get(rid)   # or pre-failover owner
            if req is None:
                continue
            if u.get("reset"):
                req.tokens = [int(t) for t in u["tokens"]]
            else:
                req.tokens.extend(int(t) for t in u["tokens"])
            if u["done"]:
                req.done = True
                req.finish_reason = u["finish_reason"]
                _obs.serving_trace_finish(req, req.finish_reason)
            elif not req.done:
                req.finish_reason = u["finish_reason"]
        if not _tr.enabled:
            return
        for d in reply.get("spans", ()):
            rid = int(d["rid"])
            req = self._live.get(rid)
            tr = getattr(req, "trace", None) if req is not None \
                else None
            if tr is None:
                continue
            tr.add(Span(d["name"], d["start_ns"], d["end_ns"],
                        replica=d.get("replica", -1),
                        slot=d.get("slot", -1), seq=d.get("seq", -1),
                        meta=d.get("meta")),
                   tokens_seen=bool(req.tokens))

    def _prune_finished(self) -> None:
        for rid in [r for r, req in self._live.items() if req.done]:
            del self._live[rid]
            self._meta.pop(rid, None)
            self._owner.pop(rid, None)

    def _has_work(self) -> bool:
        if any(not e["req"].done for e in self._rq):
            return True
        return any(not req.done for req in self._live.values())

    def _publish(self):
        if not _obs.enabled:
            return
        for i, s in self._alive(range(len(self.nodes))).items():
            _obs.serving_router_replica(
                i, s["queued_total"], s["pool_occupancy"],
                s["degraded_level"])

    # ---- prefill→decode handoff over the wire ----

    def _harvest_handoffs(self):
        """Hand every decode-ready request off its prefill worker while a
        decode worker has a free slot. Unlike the in-process cluster,
        whose export is a read of its own memory, an export here ships
        the request's pages over the wire: with every decode slot taken
        (this step's ``load_stats``, less the slots this harvest filled)
        nothing is exported, rather than shipped to be refused."""
        decode = self._alive(self._decode_idxs())
        if not decode:
            return
        free = {d: int(s.get("free_slots", 1)) for d, s in decode.items()}
        for i in self._prefill_idxs():
            if not self._serviceable(i):
                continue
            try:
                ready, _ = self.nodes[i].call("handoff_ready")
            except (ReplicaUnreachable, EngineDead):
                self._failover(i)
                continue
            for rid in ready["rids"]:
                if not any(n > 0 for n in free.values()):
                    return
                req = self._live.get(int(rid))
                if req is None or req.done \
                        or self._owner.get(int(rid)) != i:
                    continue
                try:
                    self._handoff_one(i, req, decode)
                except (ReplicaUnreachable, EngineDead):
                    self._failover(i)
                    break
                owner = self._owner.get(int(rid))
                if owner in free and owner != i:
                    free[owner] -= 1

    def _handoff_one(self, i: int, req, decode_loads: Dict[int, Dict]):
        node = self.nodes[i]
        t0 = _obs.generate_begin()
        # the in-process handoff's control-plane fault site: fires
        # before the pure-read export, commits nothing
        fault_point("handoff_export")
        tx = _obs.serving_trace_now()
        out, blobs = node.call("export_prefilled", {"rid": req.rid})
        # the exporter's token list is authoritative for the adopt
        # record: the controller's view may trail by this step's delta
        req.tokens = [int(t) for t in out["tokens"]]
        if tamper_point("handoff_export"):
            # injected wire corruption: flip real payload bytes; the
            # decode-side CRC check must refuse the install
            entry = _tampered_entry(entry_from_wire(out["kv"], blobs))
            out["kv"], blobs = entry_to_wire(entry)
        nbytes = sum(a.nbytes for a in blobs.values())
        pages = int(out["kv"].get("num_pages", 0))
        _obs.serving_handoff_export(t0, nbytes, pages)
        _obs.serving_trace_span(req, "handoff_export", tx, replica=i,
                                slot=out["slot"], seq=len(req.tokens),
                                meta={"bytes": int(nbytes),
                                      "pages": pages, "wire": True})
        record = request_record(req, now=self.clock())
        placed = None
        placed_slot = -1
        for didx in sorted(decode_loads,
                           key=lambda d: self.router._score(
                               decode_loads[d]) + (d,)):
            if not self._serviceable(didx):
                continue
            t1 = _obs.generate_begin()
            t1t = _obs.serving_trace_now()
            attempts = 0
            while True:
                try:
                    fault_point("handoff_import")
                    reply, _ = self.nodes[didx].call(
                        "adopt_prefilled",
                        {"record": record, "slot": out["slot"],
                         "length": out["length"], "last": out["last"],
                         "kv": out["kv"]}, blobs=blobs)
                    if reply["ok"]:
                        placed = didx
                        placed_slot = int(reply["slot"])
                        _obs.serving_handoff_import(t1)
                        _obs.serving_trace_span(
                            req, "handoff_import", t1t, replica=didx,
                            slot=placed_slot, seq=len(req.tokens),
                            meta={"src": int(i)})
                    break           # placed, or no free slot there
                except PoolExhausted:
                    break           # full pool: try the next replica
                except CorruptionDetected:
                    # the checksum refused the payload BEFORE install:
                    # nothing committed on the decode side, and the
                    # request keeps decoding on its prefill replica,
                    # token-identically. The corrupt payload dies with
                    # this attempt.
                    self.handoff_corruptions_total += 1
                    _obs.serving_integrity("handoff", "detected")
                    _obs.serving_integrity("handoff", "quarantined")
                    return
                except ReplicaUnreachable:
                    self._failover(didx)
                    break           # try the next decode replica
                except (InjectedFault, Exception) as exc:  # noqa: BLE001
                    attempts += 1
                    if isinstance(exc, EngineDead) \
                            or attempts > self.handoff_retries:
                        if isinstance(exc, EngineDead):
                            self._failover(didx)
                        break       # next replica (bounded retry
                    self.handoff_retries_total += 1  # exhausted)
                    self._retry_sleep(
                        min(0.2, 0.005 * 2 ** (attempts - 1)))
            if placed is not None:
                break
        if placed is None:
            return                  # opportunistic: stays on prefill
        self._owner[req.rid] = placed
        node.call("finish_handoff",
                  {"rid": req.rid, "slot": out["slot"]})
        self.handoffs_total += 1

    # ---- failover / retirement / autoscaling ----

    def _failover(self, idx: int) -> None:
        """A worker process is gone (kill -9, circuit open, torn
        transport). Spawn a replacement on the SAME WAL directory with
        recovery on, re-anchor controller handles to its recovered
        records, durably forget resurrected already-finished sessions,
        and rehome what the torn tail lost."""
        node = self.nodes[idx]
        if node is None:
            return
        self.failovers_total += 1
        node.kill()
        self.nodes[idx] = None
        try:
            replacement = self._spawn_node(idx, recover=True)
        except Exception:  # noqa: BLE001 - no replacement possible:
            # transport loss is now permanent for the sessions owned
            # there: finish them with the transport reason (not
            # engine_dead: the engine state is intact on disk, the
            # PROCESS is what cannot be reached)
            for rid in self._owned_live(idx):
                req = self._live[rid]
                req.done = True
                req.finish_reason = \
                    FinishReason.REPLICA_UNREACHABLE.value
                _obs.serving_cancelled(1, req.finish_reason)
                _obs.serving_trace_finish(req, req.finish_reason)
            self.router.drop_replica(idx)
            return
        self.nodes[idx] = replacement
        self.router.drop_replica(idx)
        recovered = {int(r["rid"]): r
                     for r in replacement.hello.get("recovered", [])}
        for rid, rec in recovered.items():
            req = self._live.get(rid)
            if req is None or req.done:
                # the WAL resurrected a session whose forget tombstone
                # (or final tokens) outran the group commit: the
                # controller's verdict wins; durably drop it on the
                # replacement so nothing is served twice
                try:
                    replacement.call("forget", {"rid": rid})
                except ReplicaUnreachable:
                    pass
                continue
            # re-anchor to durable state: the greedy replay regenerates
            # any group-commit-lagged tokens bit-identically
            req.done = False
            req.slot = None
            req.tokens = [int(t) for t in rec["tokens"]]
            req.preemptions = int(rec["preemptions"]) \
                + (1 if rec["admitted"] else 0)
            req.finish_reason = (FinishReason.PREEMPTED.value
                                 if rec["admitted"] else None)
            self._owner[rid] = idx
            _obs.serving_trace_mark(req, "wal_replay", replica=idx,
                                    seq=len(req.tokens))
        # sessions the controller owns there but the WAL never made
        # durable: the controller copy is the only copy; rehome it
        for rid in self._owned_live(idx):
            req = self._live[rid]
            if rid in recovered or req.done:
                continue
            _obs.serving_trace_mark(req, "rehome", replica=idx)
            req.slot = None
            meta = self._meta.get(rid,
                                  {"tenant": "default",
                                   "cost": req.prompt.shape[1]
                                   + req.max_new_tokens})
            self._rq.append({"req": req, "tenant": meta["tenant"],
                             "cost": meta["cost"], "seq": self._seq})
            self._seq += 1
            del self._owner[rid]

    def _rehome_records(self, records: List[Dict]) -> None:
        """Requeue drained sessions (retirement) through the router:
        in-flight ones resume with preempted semantics on whichever
        replica dispatch picks."""
        for rec in records:
            rid = int(rec["rid"])
            req = self._live.get(rid)
            if req is None or req.done:
                continue
            req.done = False
            req.slot = None
            req.tokens = [int(t) for t in rec["tokens"]]
            if rec["admitted"]:
                req.preemptions = int(rec["preemptions"])
            req.finish_reason = None
            meta = self._meta.get(rid,
                                  {"tenant": "default",
                                   "cost": req.prompt.shape[1]
                                   + req.max_new_tokens})
            self._owner.pop(rid, None)
            self._rq.append({"req": req, "tenant": meta["tenant"],
                             "cost": meta["cost"], "seq": self._seq})
            self._seq += 1

    def retire_replica(self, idx: int, replace: bool = True) -> Dict:
        """Drain a worker (checkpoint + live records over RPC), shut its
        process down, rehome its sessions; optionally spawn a fresh
        replacement in the slot."""
        node = self.nodes[idx]
        if node is None:
            raise ValueError(f"replica {idx} has no live worker")
        node.draining = True
        path = os.path.join(self.workdir, f"retire{idx:03d}.ckpt")
        try:
            summary, _ = node.call("drain", {"path": path})
        except (ReplicaUnreachable, EngineDead):
            node.draining = False
            self._failover(idx)
            return {"failover": True}
        node.close()
        self.nodes[idx] = None
        self.router.drop_replica(idx)
        self._rehome_records(summary.pop("records", []))
        self.retirements_total += 1
        if replace:
            self.nodes[idx] = self._spawn_node(idx)
        return summary

    def _spawn_replica(self) -> int:
        for i in self._decode_idxs():
            if self.nodes[i] is None:
                self.nodes[i] = self._spawn_node(i)
                self.router.drop_replica(i)
                return i
        idx = len(self.nodes)
        self.nodes.append(self._spawn_node(idx))
        return idx

    def _autoscale_tick(self):
        if self.autoscaler is None:
            return
        try:
            fault_point("autoscale_tick")
        except Exception:  # noqa: BLE001 - best-effort control plane
            self.autoscale_faults_total += 1
            return
        every = self._alive(range(len(self.nodes)))
        alive = {i: s for i, s in every.items()
                 if i >= self.prefill_replicas}
        if not alive:
            return
        backlog = (
            sum(1 for e in self._rq if not e["req"].done)
            + sum(s["queued_total"] + s["pending_prefills"]
                  for s in every.values()))
        per = backlog / len(alive)
        max_rung = max(s["degraded_level"] for s in every.values())
        action = self.autoscaler.decide(per, len(alive), max_rung)
        if action == "up":
            self._spawn_replica()
            _obs.serving_autoscale("up", len(alive) + 1, per)
        elif action == "down":
            victim = min(alive,
                         key=lambda i: self.router._score(alive[i])
                         + (i,))
            self.retire_replica(victim, replace=False)
            _obs.serving_autoscale("down", len(alive) - 1, per)

    # ---- introspection ----

    def tier_stats(self, idx: int = 0) -> Dict:
        out, _ = self.nodes[idx].call("tier_stats")
        return out
