"""The port's multi-process serving cluster against the JAX package's, on
the CPU (``paddle_tpu_torch/serving/rpc.py``, ``fabric.py``,
``node.py`` and ``multiproc.py``).

- **Across the packages, no subprocess**: ``encode_message`` gives the
  same bytes in both for the same header and blobs (a 33 MiB blob takes
  the port's threaded CRC); each decodes the other's frames; a JAX
  ``RpcServer`` in a thread answers a port ``RpcClient`` and the other
  way round, typed remote errors included; ``key_to_wire`` /
  ``entry_to_wire`` agree; a fabric entry one package's client put
  (f32 and bf16 arrays) is read by the other's client, its CRCs
  checked.
- **The reference's unit contracts, port against port**:
  ``tests/test_multiproc.py``'s ``TestRpcFraming``,
  ``TestRpcClientServer`` and ``TestFabricIntegrity`` (the corrupt
  promote falls back to replay token-identically on the port's
  engine).
- **One process tree** (the reference's headline gate): a port
  ``MultiProcessCluster`` of 1 prefill + 1 decode CPU worker on the
  JAX tiny Llama's weights (an ``.npz``), the decode worker
  ``SIGKILL``ed mid-trace: tokens identical to the JAX in-process
  ``ServingCluster`` on the reference's seeded jobs, trace spans
  stitched across both workers, and phase 3l's gates
  (``chip_smoke.check_cluster_handles``, ``check_multiproc_tokens``,
  ``check_pages_bytes`` on the first wire handoff) passing this run and
  rejecting a doubled rid, a changed token and a flipped page byte.
- **One more tree**: the multi-process chaos soak (a copy of
  ``tools/chaos_soak.py``'s ``run_multiproc_soak``, kept here) on a
  fabric process, then the fabric warm start on that fabric: a fresh
  worker promotes the soak's system prompt, tokens equal to the cold
  engine's.
- A worker asked for the card on a machine without one (the factory's
  default) fails its cluster's construction with the end of its log
  (beside the first tree).

Every worker runs on ``device="cpu"`` with one thread
(``OMP_NUM_THREADS=1``), and every tree is closed in ``finally``.
"""
import os
import signal
import socket
import struct
import sys
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from paddle_tpu.models import llama as jl
from paddle_tpu.serving import FaultInjector as JInjector
from paddle_tpu.serving import fabric as jfabric
from paddle_tpu.serving import rpc as jrpc
from paddle_tpu.serving.host_tier import HostPageStore as JStore
from paddle_tpu.serving.resilience import CorruptionDetected as JCorrupt
from paddle_tpu_torch.observability import tracing as ttracing
from paddle_tpu_torch.serving import FaultInjector
from paddle_tpu_torch.serving import fabric as tfabric
from paddle_tpu_torch.serving import rpc as trpc
from paddle_tpu_torch.serving.host_tier import HostPageStore as TStore
from paddle_tpu_torch.serving.host_tier import _tampered_entry
from paddle_tpu_torch.serving.multiproc import (FabricProcess,
                                                MultiProcessCluster)
from paddle_tpu_torch.serving.node import llama_engine, save_params_npz
from paddle_tpu_torch.serving.paged_cache import raw_bytes
from paddle_tpu_torch.serving.resilience import CorruptionDetected
from paddle_tpu_torch.serving.rpc import (MAGIC, ReplicaUnreachable,
                                          RpcClient, RpcClosed,
                                          RpcCorruptFrame, RpcServer,
                                          RpcTornFrame, SocketTransport,
                                          decode_message, encode_message)

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))
import chip_smoke  # noqa: E402
import test_torch_scheduler as ts  # noqa: E402

RPC = {"jax": jrpc, "port": trpc}
FABRIC = {"jax": jfabric, "port": tfabric}
STORE = {"jax": JStore, "port": TStore}
INJECTOR = {"jax": JInjector, "port": FaultInjector}
WORKER_ENV = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
CPU = dict(device="cpu")


def _bf16(a):
    import ml_dtypes
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16)


def _stop(srv):
    """Shut a server of either package down. The JAX package's listener
    close does not wake its accept thread, whose join then waits out a
    2 s timeout; shutting the socket down first wakes it."""
    try:
        getattr(srv, "rpc", srv)._sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    srv.shutdown()


def _message(case):
    header = {"id": 7, "kind": "call", "method": "x", "client": "c.1",
              "data": {"a": 1, "f": 2.5, "s": "txt", "n": np.int64(9),
                       "l": [1, 2]}}
    rs = np.random.RandomState(5)
    blobs = {"empty": None,
             "blobs": {"k": np.arange(24, dtype=np.uint8).reshape(2, 12),
                       "v": np.linspace(0, 1, 6, dtype=np.float32),
                       "i": np.arange(5, dtype=np.int32)},
             "large": {"pages": rs.randint(0, 256, (32 << 20) + 4099)
                       .astype(np.uint8),
                       "tail": np.arange(3, dtype=np.float32)}}[case]
    return header, blobs


# ------------------------------------------------- across the packages

@pytest.mark.parametrize("case", ["empty", "blobs", "large"])
def test_frames_are_byte_equal_across_packages(case):
    header, blobs = _message(case)
    got = trpc.encode_message(header, blobs)
    assert got == jrpc.encode_message(header, blobs)
    assert b"".join(trpc.encode_frame(header, blobs)) == got
    assert got[:4] == MAGIC


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_each_package_decodes_the_others_frames(writer, reader):
    header, blobs = _message("blobs")
    frame = RPC[writer].encode_message(header, blobs)
    magic, n, crc = struct.unpack("<4sII", frame[:12])
    assert (magic, n) == (MAGIC, len(frame) - 12)
    hdr, out = RPC[reader].decode_message(frame[12:])
    assert hdr["id"] == 7 and hdr["data"]["n"] == 9
    assert hdr["data"]["l"] == [1, 2]
    assert set(out) == set(blobs)
    for k, a in blobs.items():
        assert out[k].dtype == a.dtype and np.array_equal(out[k], a)
    # a frame through the port's socket transport: CRC-checked into one
    # owned buffer whose slices are the blobs
    a, b = socket.socketpair()
    try:
        a.sendall(frame)
        payload = SocketTransport(b).recv_frame()
        hdr2, out2 = trpc.decode_message(payload)
        assert hdr2 == hdr and all(np.array_equal(out2[k], blobs[k])
                                   for k in blobs)
        out2["k"][0, 0] = 255       # writable, the caller's own
    finally:
        a.close()
        b.close()


class _Echo:
    def __init__(self, corrupt):
        self.calls = 0
        self._corrupt = corrupt

    def rpc_echo(self, data, blobs):
        self.calls += 1
        return dict(data), dict(blobs)

    def rpc_corrupt(self, data, blobs):
        raise self._corrupt("wire")


@pytest.mark.parametrize("server,client", [("jax", "port"),
                                           ("port", "jax")])
def test_rpc_server_answers_the_other_packages_client(server, client):
    corrupt = {"jax": JCorrupt, "port": CorruptionDetected}
    handler = _Echo(corrupt[server])
    srv = RPC[server].RpcServer(handler).start()
    cli = RPC[client].RpcClient.dial(srv.host, srv.port, retries=1,
                                     backoff_s=0.0, sleep=lambda s: None)
    try:
        blobs = {"pages": np.arange(4096, dtype=np.uint8),
                 "f": np.ones((3, 2), np.float32)}
        data, out = cli.call("echo", {"x": 3, "y": [1, "z"]}, blobs)
        assert data == {"x": 3, "y": [1, "z"]} and handler.calls == 1
        assert all(np.array_equal(out[k], blobs[k]) for k in blobs)
        with pytest.raises(corrupt[client]) as ei:
            cli.call("corrupt")
        assert ei.value.site == "wire" and cli.retries_total == 0
        with pytest.raises(ValueError):
            cli.call("no_such_method")
    finally:
        cli.close()
        _stop(srv)


def test_fabric_wire_codecs_agree():
    keys = [b"\x00\x01chain", "s", 7, ("swap", 3), (b"a", ("b", 1))]
    for k in keys:
        w = tfabric.key_to_wire(k)
        assert w == jfabric.key_to_wire(k)
        assert tfabric.key_from_wire(w) == jfabric.key_from_wire(w) == k
    arrays = {"k": np.arange(48, dtype=np.float32).reshape(1, 3, 16),
              "v": _bf16(np.linspace(-1, 1, 48).reshape(1, 3, 16)),
              "s": np.arange(6, dtype=np.int8).reshape(1, 3, 2)}
    got = {}
    for side in ("jax", "port"):
        entry = STORE[side].encode(arrays)
        entry["extra"], entry["persist"] = {"tokens": [1, 2]}, True
        got[side] = FABRIC[side].entry_to_wire(entry)
    (jd, jb), (td, tb) = got["jax"], got["port"]
    assert td == jd
    assert set(tb) == set(jb) and all(
        np.array_equal(tb[k], jb[k]) for k in jb)
    # a port entry that keeps its typed tensors leaves them home
    entry = TStore.encode({"k": torch.arange(6, dtype=torch.bfloat16)})
    data, blobs = tfabric.entry_to_wire(entry)
    assert "tensors" in entry and "tensors" not in data
    assert tfabric.entry_from_wire(data, blobs)["arrays"].keys() == {"k"}


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_fabric_entry_crosses_the_packages(writer, reader):
    """The writer's client puts an entry into its own package's fabric
    server (in a thread); the reader's client gets it there with its
    CRCs checked, and a tampered fetch reads as a miss."""
    srv = FABRIC[writer].FabricServer(page_size=8).start()
    clients = {side: FABRIC[side].FabricClient.dial(
        "127.0.0.1", srv.port, page_size=8, retries=1, backoff_s=0.0,
        sleep=lambda s: None) for side in (writer, reader)}
    arrays = {"k": np.random.RandomState(1).randn(2, 1, 8, 4)
              .astype(np.float32),
              "v": _bf16(np.random.RandomState(2).randn(2, 1, 8, 4))}
    try:
        clients[writer].put(b"chain/1", arrays, extra={"span": 1},
                            persist=True)
        entry = clients[reader].get(b"chain/1")
        assert entry is not None and entry["extra"] == {"span": 1}
        back = STORE[reader].decode(entry)
        for k, a in arrays.items():
            b = back[k]
            assert tuple(b.shape) == a.shape
            assert str(b.dtype).replace("torch.", "") == str(a.dtype)
            got = (raw_bytes(b) if isinstance(b, torch.Tensor)
                   else np.ascontiguousarray(b)).tobytes()
            assert got == a.tobytes()
        assert clients[reader].hits_total == 1
        inj = INJECTOR[reader](seed=0)
        with inj:
            inj.arm_tamper("fabric_get", nth=1)
            assert clients[reader].get(b"chain/1") is None
        assert clients[reader].quarantined_total == 1
        assert not clients[writer].contains(b"chain/1")
    finally:
        for c in clients.values():
            c.close()
        _stop(srv)


def _registry(obs):
    """Every metric's kind, help, labels and values, a histogram's as its
    bucket bounds and sample count (its sum is wall time)."""
    out = {}
    for name, m in obs.REGISTRY.to_json().items():
        vals = {k: (sorted(v["buckets"]), v["count"])
                if isinstance(v, dict) else v
                for k, v in m["values"].items()}
        out[name] = (m["kind"], m["help"], vals)
    return out


def test_rpc_and_fabric_hooks_match_jax():
    """The eight RPC and fabric hooks emit the JAX package's metrics:
    names, kinds, help, labels, histogram buckets and counts."""
    import paddle_tpu.observability as jobs
    import paddle_tpu_torch.observability as tobs
    got = {}
    for side, obs in (("jax", jobs), ("port", tobs)):
        obs.REGISTRY.clear()
        obs.enable()
        try:
            h = obs.hooks
            t0 = h.generate_begin()
            h.serving_rpc_call("step", t0, 100, 20)
            h.serving_rpc_call("adopt_prefilled", t0, 4096, 30)
            h.serving_rpc_served("step", t0)
            h.serving_rpc_retry("step")
            h.serving_rpc_timeout("load_stats")
            h.serving_rpc_corrupt("crc")
            h.serving_rpc_corrupt("torn")
            h.serving_fabric_demote(t0, 4096)
            h.serving_fabric_promote(t0, 4096, True)
            h.serving_fabric_promote(t0, 0, False)
            h.serving_fabric_quarantine("fabric_get")
            got[side] = _registry(obs)
        finally:
            obs.disable()
            obs.REGISTRY.clear()
    assert got["port"] == got["jax"]
    assert len(got["port"]) == 15


# ------------------------------ the reference's contracts, port on port

def _pipe_transports():
    a, b = socket.socketpair()
    return SocketTransport(a), SocketTransport(b)


class TestRpcFraming:
    def test_codec_roundtrip_with_blobs(self):
        header = {"id": 7, "kind": "call", "method": "x",
                  "data": {"a": 1, "f": 2.5, "s": "txt",
                           "n": np.int64(9)}}
        blobs = {"k": np.arange(24, dtype=np.uint8).reshape(2, 12),
                 "v": np.linspace(0, 1, 6, dtype=np.float32)}
        frame = encode_message(header, blobs)
        assert frame[:4] == MAGIC
        hdr, out = decode_message(frame[12:])
        assert hdr["id"] == 7 and hdr["data"]["n"] == 9
        assert np.array_equal(out["k"], blobs["k"])
        assert np.array_equal(out["v"], blobs["v"])
        out["k"][0, 0] = 255        # decoded blobs are owned copies

    def test_torn_frame_detected(self):
        tx, rx = _pipe_transports()
        frame = encode_message({"id": 1, "kind": "call"})
        tx.sock.sendall(frame[:len(frame) - 3])     # die mid-write
        tx.close()
        with pytest.raises(RpcTornFrame):
            rx.recv_frame()
        rx.close()

    def test_bitflip_detected_before_decode(self):
        tx, rx = _pipe_transports()
        frame = bytearray(encode_message({"id": 1, "kind": "call",
                                          "data": {"x": 1}}))
        frame[-1] ^= 0x40                           # flip a payload bit
        tx.sock.sendall(bytes(frame))
        with pytest.raises(RpcCorruptFrame):
            rx.recv_frame()
        tx.close()
        rx.close()

    def test_bad_magic_rejected(self):
        tx, rx = _pipe_transports()
        frame = bytearray(encode_message({"id": 1, "kind": "call"}))
        frame[:4] = b"PTWL"         # a WAL segment fed to the socket
        tx.sock.sendall(bytes(frame))
        with pytest.raises(RpcCorruptFrame):
            rx.recv_frame()
        tx.close()
        rx.close()

    def test_half_closed_socket_is_clean_close(self):
        tx, rx = _pipe_transports()
        tx.close()                  # peer gone between frames
        with pytest.raises(RpcClosed):
            rx.recv_frame()
        rx.close()

    def test_oversize_length_rejected(self):
        tx, rx = _pipe_transports()
        tx.sock.sendall(struct.pack("<4sII", MAGIC, (1 << 30) + 1, 0))
        with pytest.raises(RpcCorruptFrame):
            rx.recv_frame()
        tx.close()
        rx.close()


class TestRpcClientServer:
    def _serve(self):
        handler = _Echo(CorruptionDetected)
        server = RpcServer(handler).start()
        client = RpcClient.dial(server.host, server.port, retries=2,
                                backoff_s=0.0, sleep=lambda s: None)
        return handler, server, client

    def test_call_roundtrip_blobs(self):
        handler, server, client = self._serve()
        try:
            blobs = {"pages": np.arange(16, dtype=np.uint8)}
            data, out = client.call("echo", {"x": 3}, blobs)
            assert data == {"x": 3}
            assert np.array_equal(out["pages"], blobs["pages"])
            assert handler.calls == 1
            assert client.retries_total == 0
        finally:
            client.close()
            server.shutdown()

    def test_dropped_reply_retries_into_dedupe_cache(self):
        """A fault after the receive drops a DELIVERED reply: the retry
        replays the server's cached frame; the handler runs ONCE."""
        handler, server, client = self._serve()
        try:
            with FaultInjector(seed=0) as inj:
                inj.arm("rpc_recv", "raise", nth=1)
                data, _ = client.call("echo", {"x": 9})
            assert data == {"x": 9}
            assert handler.calls == 1
            assert client.retries_total == 1
            assert server.deduped_replies == 1
        finally:
            client.close()
            server.shutdown()

    def test_dropped_send_retries_fresh_execution(self):
        handler, server, client = self._serve()
        try:
            with FaultInjector(seed=0) as inj:
                inj.arm("rpc_send", "raise", nth=1)
                data, _ = client.call("echo", {"x": 4})
            assert data == {"x": 4}
            # the frame never reached the server: one execution
            assert handler.calls == 1
            assert server.deduped_replies == 0
            assert client.retries_total == 1
        finally:
            client.close()
            server.shutdown()

    def test_remote_typed_error_no_retry(self):
        handler, server, client = self._serve()
        try:
            with pytest.raises(CorruptionDetected) as ei:
                client.call("corrupt")
            assert ei.value.site == "wire"
            assert client.retries_total == 0
        finally:
            client.close()
            server.shutdown()

    def test_unknown_method_is_value_error(self):
        handler, server, client = self._serve()
        try:
            with pytest.raises(ValueError):
                client.call("no_such_method")
        finally:
            client.close()
            server.shutdown()

    def test_timeout_bounded_retry_structured_error(self):
        """A server that accepts but never replies costs exactly
        (retries + 1) timed-out attempts and a ReplicaUnreachable with
        the replica's label, never a hang."""
        listener = socket.socket()
        listener.bind(("127.0.0.1", 0))
        listener.listen(4)
        conns = []

        def _blackhole():
            while True:
                try:
                    c, _ = listener.accept()
                except OSError:
                    return
                conns.append(c)     # read nothing, reply nothing

        threading.Thread(target=_blackhole, daemon=True).start()
        host, port = listener.getsockname()[:2]
        client = RpcClient.dial(host, port, label="replica9", retries=2,
                                timeout_s=0.05, backoff_s=0.0,
                                sleep=lambda s: None)
        try:
            t0 = time.monotonic()
            with pytest.raises(ReplicaUnreachable) as ei:
                client.call("step")
            assert ei.value.label == "replica9"
            assert client.timeouts_total == 3    # retries + 1 attempts
            assert time.monotonic() - t0 < 5.0
        finally:
            client.close()
            listener.close()
            for c in conns:
                c.close()


class TestFabricIntegrity:
    def _fabric(self):
        server = tfabric.FabricServer(page_size=8).start()
        client = tfabric.FabricClient.dial(
            "127.0.0.1", server.port, page_size=8, retries=1,
            backoff_s=0.0, sleep=lambda s: None)
        return server, client

    def test_put_get_roundtrip(self):
        server, client = self._fabric()
        try:
            arrays = {"k": np.arange(64, dtype=np.uint8).reshape(2, 32)}
            client.put(b"chain/1", arrays, extra={"span": 1},
                       persist=True)
            entry = client.get(b"chain/1")
            assert entry is not None
            assert entry["arrays"]["k"].tobytes() \
                == arrays["k"].tobytes()
            assert entry["extra"] == {"span": 1}
            assert client.hits_total == 1
            assert server.store.stats()["puts_total"] == 1
        finally:
            client.close()
            server.shutdown()

    def test_corrupt_promote_quarantines_and_misses(self):
        server, client = self._fabric()
        try:
            client.put(b"chain/x", {"k": np.arange(32, dtype=np.uint8)})
            with FaultInjector(seed=0) as inj:
                inj.arm_tamper("fabric_get", nth=1)
                assert client.get(b"chain/x") is None
            assert client.quarantined_total == 1
            assert client.misses_total == 1
            # quarantined server-side too: a re-fetch is a miss
            assert client.get(b"chain/x") is None
            assert server.store.stats()["quarantined_total"] >= 1
        finally:
            client.close()
            server.shutdown()

    def test_corrupt_inbound_put_refused(self):
        server, client = self._fabric()
        try:
            entry = TStore.encode({"k": np.arange(16, dtype=np.uint8)})
            entry["extra"] = {}
            entry["persist"] = False
            data, blobs = tfabric.entry_to_wire(_tampered_entry(entry))
            data["key"] = tfabric.key_to_wire(b"chain/bad")
            with pytest.raises(CorruptionDetected):
                client._rpc.call("put", data, blobs)
            assert server.quarantined_inbound == 1
            assert not client.contains(b"chain/bad")
        finally:
            client.close()
            server.shutdown()

    def test_corrupt_promote_falls_back_to_replay_token_identical(self):
        """An engine warming its prefix tier from the fabric hits a
        corrupt chain, quarantines it, and the admission replays: the
        tokens of the clean warm path and of the cold path."""
        rs = np.random.RandomState(11)
        prompt = rs.randint(3, 256, (24,)).astype(np.int32)
        server, seeder = self._fabric()
        warm = hurt = None
        try:
            cold = llama_engine(**CPU)()
            ref = np.asarray(cold.generate([prompt], max_new_tokens=6)[0])
            eng1 = llama_engine(store=seeder, **CPU)()
            out1 = np.asarray(eng1.generate([prompt], max_new_tokens=6)[0])
            assert np.array_equal(out1, ref)
            assert seeder.puts_total > 0
            warm = tfabric.FabricClient.dial("127.0.0.1", server.port,
                                             page_size=8)
            eng2 = llama_engine(store=warm, **CPU)()
            out2 = np.asarray(eng2.generate([prompt], max_new_tokens=6)[0])
            assert np.array_equal(out2, ref)
            assert warm.hits_total > 0
            assert eng2.cache.promote_hits_total > 0
            eng1b = llama_engine(store=seeder, **CPU)()
            eng1b.generate([prompt], max_new_tokens=6)
            hurt = tfabric.FabricClient.dial("127.0.0.1", server.port,
                                             page_size=8)
            eng3 = llama_engine(store=hurt, **CPU)()
            with FaultInjector(seed=0) as inj:
                inj.arm_tamper("fabric_get", nth=1)
                out3 = np.asarray(eng3.generate([prompt],
                                                max_new_tokens=6)[0])
            assert np.array_equal(out3, ref)    # replay == warm == cold
            assert hurt.quarantined_total >= 1
        finally:
            for c in (warm, hurt, seeder):
                if c is not None:
                    c.close()
            server.shutdown()


# ------------------------------------------------- the process trees

def _seeded_jobs(seed=3, lens=(6, 12, 9, 5, 14, 7), max_new=8):
    rs = np.random.RandomState(seed)
    prompts = [rs.randint(3, 256, (n,)).astype(np.int32) for n in lens]
    return prompts, max_new


def _jax_inprocess(prompts, max_new):
    """The JAX package's in-process cluster of the same shape, on its
    own tiny Llama (``jax.random.key(0)``)."""
    from paddle_tpu.serving.cluster import ServingCluster
    from paddle_tpu.serving.node import tiny_llama_engine
    make = tiny_llama_engine()

    def factory():
        # both replicas' engines run one set of compiled programs
        eng = make()
        ts._share_programs(eng)
        return eng
    ref = ServingCluster(factory, replicas=2,
                         prefill_replicas=1,
                         supervisor_kw=dict(sleep=lambda s: None,
                                            backoff_s=0.0))
    handles = [ref.submit(p, max_new_tokens=max_new) for p in prompts]
    while ref.step():
        pass
    assert all(h.done for h in handles)
    return [list(map(int, h.tokens)) for h in handles]


def _jax_weights(path):
    """The JAX tiny Llama's weights (``tiny_llama_engine``'s: key 0) as
    the ``.npz`` a port worker loads."""
    cfg = jl.LlamaConfig.tiny(num_layers=2, max_seq_len=64)
    save_params_npz(path, jax.tree.map(
        np.asarray, jl.init_params(jax.random.key(0), cfg)))


def test_kill9_tree_matches_jax_cluster(tmp_path):
    """HEADLINE: 1 prefill + 1 decode port worker process on the JAX
    weights, the decode worker SIGKILLed once it owns decoded tokens:
    every request finishes once with the JAX in-process cluster's
    tokens, the replacement recovers from the dead worker's WAL, a
    handed-off request's trace holds spans of both workers, and phase
    3l's gates pass this run and reject planted faults."""
    cardless = {}
    if not torch.cuda.is_available():
        # runs beside this tree; checked at its end
        side = threading.Thread(target=_cardless_worker, args=(
            str(tmp_path / "cardless"), cardless))
        side.start()
    prompts, max_new = _seeded_jobs()
    npz = str(tmp_path / "tiny.npz")
    _jax_weights(npz)
    # the JAX reference runs on a thread while the workers start and
    # serve (their side of the tree waits on sockets and processes)
    jax_ref = {}

    def reference():
        try:
            jax_ref["tokens"] = _jax_inprocess(prompts, max_new)
        except Exception as e:  # noqa: BLE001 - raised below
            jax_ref["error"] = e
    jax_thread = threading.Thread(target=reference)
    jax_thread.start()
    ttracing.enable()
    mc = None
    try:
        mc = MultiProcessCluster(
            replicas=2, prefill_replicas=1, workdir=str(tmp_path / "mp"),
            trace=True, factory_kw=dict(params_path=npz, **CPU),
            env=WORKER_ENV)
        seen = chip_smoke.watch_first_wire_handoff(mc)
        handles = [mc.submit(p, max_new_tokens=max_new) for p in prompts]
        killed, steps = False, 0
        while mc.step():
            steps += 1
            if not killed and any(
                    len(h.tokens) >= 2 and mc._owner.get(h.rid) == 1
                    for h in handles if not h.done):
                os.kill(mc.nodes[1].proc.pid, signal.SIGKILL)
                killed = True
            assert steps < 400, "the multi-process cluster did not drain"
        assert killed and mc.failovers_total >= 1
        assert mc.handoffs_total >= 1
        assert mc.nodes[1].hello["recovered"]
        got = [list(map(int, h.tokens)) for h in handles]
        for h in handles:
            assert h.done and h.finish_reason in ("eos", "max_len")
        jax_thread.join()
        if "error" in jax_ref:
            raise jax_ref["error"]
        ref = jax_ref["tokens"]
        assert got == ref
        stitched = [h for h in handles if h.trace is not None
                    and {0, 1} <= set(h.trace.replicas)]
        assert stitched, "no trace spans both worker processes"
        names = {s.name for s in stitched[0].trace.spans}
        assert {"handoff_export", "handoff_import"} <= names
        # phase 3l's gates on this run, and on planted faults
        rids = [h.rid for h in handles]
        chip_smoke.check_cluster_handles("cpu", rids, handles)
        with pytest.raises(SystemExit, match="lost or doubled"):
            chip_smoke.check_cluster_handles("cpu", rids + [rids[0]],
                                             handles)
        assert chip_smoke.check_multiproc_tokens("cpu", got, ref)[
            "tokens_equal_share"] == 1.0
        bad = [list(t) for t in got]
        bad[2][-1] += 1
        with pytest.raises(SystemExit, match="tokens differ"):
            chip_smoke.check_multiproc_tokens("cpu", bad, ref)
        with pytest.raises(SystemExit, match="follow"):
            chip_smoke.check_multiproc_tokens("cpu", bad, ref, again=ref)
        assert set(seen) == {"rid", "sent", "decode"}
        chip_smoke.check_pages_bytes("cpu", seen["decode"], seen["sent"])
        flipped = {k: a.copy() for k, a in seen["sent"].items()}
        flipped[sorted(flipped)[0]].reshape(-1)[5] ^= 0x10
        with pytest.raises(SystemExit, match="byte-equal"):
            chip_smoke.check_pages_bytes("cpu", seen["decode"], flipped)
    finally:
        if mc is not None:
            mc.close()
        ttracing.disable()
        jax_thread.join()
        if not torch.cuda.is_available():
            side.join()
    if not torch.cuda.is_available():
        err = cardless.get("error")
        assert isinstance(err, RuntimeError), err
        assert "is_available" in str(err) and "replica000.log" in str(err)


class SoakError(RuntimeError):
    pass


def run_multiproc_soak(seed=0, requests=6, max_steps=600, workdir=None,
                       fabric=None):
    """A copy of ``tools/chaos_soak.py``'s ``run_multiproc_soak`` on the
    port: one prefill worker, one decode worker and a KV fabric (the
    caller's ``fabric``, kept open, when given), driven by
    ``MultiProcessCluster`` with chaos at the controller's wire seams: a
    tampered handoff export the decode side's CRC must refuse, armed
    ``rpc_send`` / ``rpc_recv`` faults the bounded retry and the dedupe
    cache must absorb, and a ``SIGKILL`` of the decode worker once it
    owns decoded tokens. Raises :class:`SoakError` on a lost or
    duplicated request, a stream other than its single-engine
    reference's, an undetected corruption, a fault that never fired or
    an unbalanced allocator."""
    import tempfile
    rs = np.random.RandomState(seed)
    sys_prompt = rs.randint(3, 256, (12,)).astype(np.int32)
    jobs = []
    for _ in range(requests):
        tail = rs.randint(3, 256,
                          (int(rs.randint(2, 7)),)).astype(np.int32)
        jobs.append((np.concatenate([sys_prompt, tail]),
                     int(rs.randint(3, 6))))
    # uninterrupted single-engine references: every process builds the
    # same weights from the seed, and per-request greedy decode does not
    # depend on the batch (f32)
    ref_engine = llama_engine(**CPU)()
    refs = [np.asarray(ref_engine.generate([p], max_new_tokens=m)[0])
            for p, m in jobs]
    wd = workdir or tempfile.mkdtemp(prefix="mp_soak_")
    t_start = time.perf_counter()
    fp = None
    mc = None
    inj = FaultInjector(seed=seed)
    try:
        fp = fabric or FabricProcess(wd, page_size=8, env=WORKER_ENV)
        mc = MultiProcessCluster(
            replicas=2, prefill_replicas=1,
            workdir=os.path.join(wd, "cluster"), fabric=fp.endpoint,
            factory_kw=CPU, env=WORKER_ENV)
        reqs = [mc.submit(p, max_new_tokens=m) for p, m in jobs]
        with inj:
            inj.arm_tamper("handoff_export", nth=1)
            inj.arm("rpc_send", "raise", nth=7)
            inj.arm("rpc_recv", "raise", nth=19)
            killed = False
            steps = 0
            while mc.step():
                steps += 1
                if not killed and any(
                        len(r.tokens) >= 2
                        and mc._owner.get(r.rid) == 1
                        for r in reqs if not r.done):
                    os.kill(mc.nodes[1].proc.pid, signal.SIGKILL)
                    killed = True
                if steps >= max_steps:
                    raise SoakError(f"multiproc soak did not drain "
                                    f"within {max_steps} steps")
        if not killed:
            raise SoakError("the decode worker never owned tokens")
        if mc.failovers_total < 1:
            raise SoakError("SIGKILL did not surface as a failover")
        if mc.handoff_corruptions_total < 1:
            raise SoakError("the tampered handoff payload was not "
                            "detected by the decode-side CRC gate")
        for site in ("rpc_send", "rpc_recv"):
            if not inj.fired.get(site):
                raise SoakError(f"armed {site} fault never fired")
        lost = [r.rid for r in reqs
                if not r.done or r.finish_reason not in ("eos",
                                                         "max_len")]
        if lost:
            raise SoakError(f"lost requests after drain: {lost}")
        mism = [r.rid for r, ref in zip(reqs, refs)
                if not np.array_equal(np.asarray(r.output), ref)]
        if mism:
            raise SoakError(f"duplicated/diverged token streams: {mism}")
        unbalanced = {}
        for i in range(len(mc.nodes)):
            st, _ = mc.nodes[i].call("tier_stats", {"drop_prefix": True})
            alloc = st["allocator"]
            if alloc["num_used"] != 0 or \
                    alloc["allocs_total"] != alloc["frees_total"]:
                unbalanced[i] = alloc
        if unbalanced:
            raise SoakError(f"allocator unbalanced after drain: "
                            f"{unbalanced}")
        fc = fp.client()
        fab_stats, _ = fc.call("stats")
        fc.close()
        if fab_stats["puts_total"] < 1:
            raise SoakError("the fabric never saw a demote")
        return {"seed": seed, "mode": "multiproc",
                "requests": len(reqs), "steps": steps,
                "failovers": mc.failovers_total,
                "handoffs": mc.handoffs_total,
                "handoff_corruptions": mc.handoff_corruptions_total,
                "faults_by_site": {s: n for s, n in inj.fired.items()
                                   if n},
                "fabric": {k: fab_stats[k]
                           for k in ("puts_total", "hits_total",
                                     "misses_total", "entries")},
                "jobs": jobs, "refs": refs,
                "elapsed_s": round(time.perf_counter() - t_start, 1)}
    finally:
        if mc is not None:
            mc.close()
        if fp is not None and fabric is None:
            fp.close()


def test_soak_smoke_then_fabric_warm_start(tmp_path):
    """One tree for both: the soak on a fabric process raises nothing;
    then a fresh worker of a new cluster on that fabric serves the
    soak's system prompt as a promote HIT (tier, client and server
    counters), with the cold engine's tokens."""
    fp = c2 = waiting = None
    box = {}
    try:
        fp = FabricProcess(str(tmp_path / "fabric"), page_size=8,
                           env=WORKER_ENV)
        ping, _ = fp.client().call("ping")
        assert ping["cuda_initialized"] is False

        def fresh_worker():
            try:
                box["c2"] = MultiProcessCluster(
                    replicas=1, workdir=str(tmp_path / "c2"),
                    fabric=fp.endpoint, factory_kw=CPU, env=WORKER_ENV)
            except Exception as e:  # noqa: BLE001 - raised below
                box["error"] = e
        # the warm start's worker starts while the soak runs; it serves
        # nothing until the soak is done
        waiting = threading.Thread(target=fresh_worker)
        waiting.start()
        report = run_multiproc_soak(seed=0, requests=6,
                                    workdir=str(tmp_path), fabric=fp)
        assert report["failovers"] >= 1
        assert report["handoff_corruptions"] >= 1
        assert report["fabric"]["puts_total"] >= 1
        assert report["faults_by_site"].get("rpc_send", 0) >= 1
        waiting.join()
        waiting = None
        if "error" in box:
            raise box["error"]
        c2 = box.pop("c2")
        (prompt, new), ref = report["jobs"][0], report["refs"][0]
        h = c2.submit(prompt, max_new_tokens=new)
        c2.run(max_steps=200)
        ts = c2.tier_stats(0)
        assert ts["tier"]["prefix_promote_hits_total"] > 0
        assert ts["fabric_client"]["hits_total"] > 0
        assert h.done and h.finish_reason in ("eos", "max_len")
        assert np.array_equal(np.asarray(h.output), ref)
        c2.close()
        c2 = None
        fc = fp.client()
        stats, _ = fc.call("stats")
        fc.close()
        assert stats["puts_total"] > 0 and stats["hits_total"] > 0
    finally:
        if waiting is not None:
            waiting.join()
        for c in (c2, box.get("c2"), fp):
            if c is not None:
                c.close()


def test_the_factory_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        llama_engine()


def _cardless_worker(workdir, box):
    """A cluster whose worker is asked for the card (the factory's
    default) on this machine: its construction must fail at once with
    the end of the worker's log (and close its tree)."""
    try:
        MultiProcessCluster(replicas=1, workdir=workdir, env=WORKER_ENV,
                            spawn_timeout_s=120.0)
    except Exception as e:  # noqa: BLE001 - inspected by the caller
        box["error"] = e
