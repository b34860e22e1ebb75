"""The port's durable journal against the JAX package's, on the CPU
(``paddle_tpu_torch/serving/wal.py`` and the supervisor's ``wal_dir``,
``checkpoint_now`` and ``recover_from_disk``).

- **Port against JAX**: ``_encode_frame`` gives the same bytes; a log
  directory either package wrote scans and folds to the same records,
  sessions and report under both packages' ``scan_segments`` /
  ``recover_state``, clean and with a torn tail, a flipped bit mid-log
  and a stale checkpoint planted (the repaired directories are
  byte-equal too); a supervisor of one package is abandoned mid-run (a
  simulated ``kill -9``) and the other package's ``recover_from_disk``
  finishes every session token-identical to the JAX engine's
  uninterrupted run, with ``checkpoint_prefix=True`` as well, where the
  restored trie serves the same prefix hits from byte-equal pages.
- **The reference's contracts, port against port** (``tests/
  test_wal.py``): the log's unit behaviour, cold restarts (f32 and int8
  KV, a swapped-out session, a constrained one, the prefix trie, a
  deadline through drain / restore / crash, a drained directory), the
  standing store's ``max_disk_bytes``.
- **The crash-point sweep**: for every engine fault site, a supervisor
  that dies at the site instead of recovering in process, then
  ``recover_from_disk``: no request lost or duplicated, greedy tokens
  equal to the port's uninterrupted run, allocators (the draft pool's
  too) and adapter pins balanced, one CRC-clean flight dump a death.
  ``draft_propose`` and ``tree_verify`` run on a draft-tree engine;
  int8 KV, a constrained-plus-adapter engine and an overlapped one
  repeat representative sites; a seeded soak kills the process a few
  times, once with a torn write. The sweep runs the port only.

The tiny f32 Llama is ``test_torch_scheduler``'s (the one of
``tests/test_wal.py``), its parameters carried across by
``convert.params_from_jax``.
"""
import json
import os
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu import serving as jserving
from paddle_tpu.serving import wal as jwal
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.observability import flight as tflight
from paddle_tpu_torch.serving import resilience as tres
from paddle_tpu_torch.serving import wal as twal

import test_torch_scheduler as ts
sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_torch_constraints as tc  # noqa: E402
import test_torch_resilience as tr  # noqa: E402

torch.set_num_threads(1)
MODS = {"jax": jserving, "port": tserving}
WALS = {"jax": jwal, "port": twal}
SUP_KW = dict(backoff_s=0.0, sleep=lambda s: None,
              wal_kw=dict(group_interval_s=0.0))
_REFS = {}


def _factory(side, kv=None, **kw):
    """A fresh engine of ``side`` a call (JAX engines share their
    compiled programs: ``test_torch_constraints._engine``)."""
    return lambda: tc._engine(side, prefill_chunk=8, kv_cache_dtype=kv,
                              **kw)


def _prompts(lens, seed=0):
    return ts._prompts(lens, seed)


def _refs(side, jobs, kv=None, **kw):
    """Each job alone, in order, on one uninterrupted engine."""
    key = (side, kv, tuple(sorted(kw.items())),
           tuple((p.tobytes(), m) for p, m in jobs))
    if key not in _REFS:
        eng = _factory(side, kv, **kw)()
        out = []
        for p, m in jobs:
            r = eng.submit(p, max_new_tokens=m)
            eng.run()
            out.append(np.asarray(r.output))
        _REFS[key] = out
    return _REFS[key]


def _segs(d):
    return sorted(f for f in os.listdir(d) if f.startswith("wal-"))


# ------------------------------------------------------ against the JAX

RECORDS = [{"rid": 3, "prompt": [5, 6, 7], "tokens": [], "priority": 1,
            "deadline_remaining_s": 0.25, "constraint": None},
           {"entries": [{"rid": 0, "toks": [9, 10], "admitted": True},
                        {"rid": 1, "fin": "eos"}], "lsn": 7,
            "kind": "steps"},
           {"hash": "ab12", "dfa": {"next": [[1, 2], [0, 0]],
                                    "note": "é ünïcode"}}]


def test_encode_frame_matches_jax():
    for rec in RECORDS:
        got, want = twal._encode_frame(rec), jwal._encode_frame(rec)
        assert got == want and got[:4] == twal.MAGIC == jwal.MAGIC
    assert twal._HDR.format == jwal._HDR.format
    assert twal.FSYNC_POLICIES == jwal.FSYNC_POLICIES
    assert (twal._seg_name(17), twal._ckpt_name(17)) == (
        jwal._seg_name(17), jwal._ckpt_name(17))


def _write_log(side, d):
    """A log with every record kind the fold reads, over several small
    segments, and a checkpoint in its middle."""
    w = WALS[side].WriteAheadLog(d, segment_bytes=256,
                                 group_interval_s=0.0)
    w.append("meta", {"page_size": 8, "max_len": 48, "max_batch": 2,
                      "kv_dtype": None, "constraints": False,
                      "draft": None, "next_rid": 0})
    for i in range(6):
        w.append("submit", {
            "rid": i, "prompt": [3 + i] * 5, "max_new_tokens": 4,
            "eos_token_id": None, "priority": 1,
            "deadline_remaining_s": None, "tokens": [],
            "admitted": False, "preemptions": 0, "swapped": False,
            "adapter_id": i % 2, "constraint": None}, flush=True)
    w.append("grammar", {"hash": "g1", "dfa": {"n": [1, 2, 3]}})
    w.append("steps", {"entries": [
        {"rid": 0, "toks": [7, 8], "admitted": True},
        {"rid": 1, "toks": [9], "admitted": True}]})
    w.append("step", {"rid": 2, "toks": [5], "preemptions": 1,
                      "swapped": True})
    w.commit()
    w.checkpoint({"sessions": [{"rid": 0, "prompt": [3] * 5,
                                "max_new_tokens": 4, "tokens": [7, 8],
                                "admitted": True},
                               {"rid": 5, "prompt": [8] * 5,
                                "max_new_tokens": 4, "tokens": [],
                                "admitted": False}],
                  "grammars": {"g0": {"n": [0]}}, "next_rid": 6,
                  "page_size": 8, "max_len": 48, "max_batch": 2,
                  "kv_dtype": None, "constraints": False,
                  "draft": None, "prefix": None},
                 {"aux": np.arange(10, dtype=np.uint8)})
    w.append("submit", {"rid": 6, "prompt": [4], "max_new_tokens": 2,
                        "tokens": [], "admitted": False}, flush=True)
    w.append("steps", {"entries": [{"rid": 0, "toks": [1]},
                                   {"rid": 6, "toks": [2],
                                    "admitted": True},
                                   {"rid": 5, "fin": "max_len"}]})
    w.append("finish", {"rid": 3, "reason": "eos"})
    w.append("forget", {"rid": 4})
    w.commit(force=True)
    w.close()


def _damage(d, how):
    if how == "torn":
        seg = os.path.join(d, _segs(d)[-1])
        with open(seg, "r+b") as f:
            f.truncate(os.path.getsize(seg) - 7)
    elif how == "bitflip":
        seg = os.path.join(d, _segs(d)[1])
        data = bytearray(open(seg, "rb").read())
        data[twal._HDR.size + 2] ^= 0xFF
        open(seg, "wb").write(bytes(data))
    elif how == "stale":
        meta = {"sessions": [{"rid": 77, "prompt": [4],
                              "max_new_tokens": 1, "tokens": [9],
                              "admitted": True}],
                "next_rid": 78, "wal_lsn": 999, "checksums": {}}
        with open(os.path.join(d, twal._ckpt_name(999)), "wb") as f:
            np.savez(f, meta=np.frombuffer(json.dumps(meta).encode(),
                                           np.uint8))


def _fold(side, d):
    recs, rep = WALS[side].scan_segments(d, repair=False)
    st = WALS[side].recover_state(d)
    files = {f: open(os.path.join(d, f), "rb").read()
             for f in sorted(os.listdir(d))}
    return recs, rep, {k: st[k] for k in ("sessions", "next_rid",
                                          "geometry", "grammars",
                                          "report")}, files


@pytest.mark.parametrize("how", ["clean", "torn", "bitflip", "stale"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_scan_and_recover_match_jax(tmp_path, writer, how):
    """Either package's directory, damaged or not, gives the same
    records, report and fold in both, and both repair it to the same
    bytes."""
    src = str(tmp_path / "src")
    _write_log(writer, src)
    _damage(src, how)
    got = {}
    for side in WALS:
        d = str(tmp_path / side)
        shutil.copytree(src, d)
        got[side] = _fold(side, d)
    assert got["port"] == got["jax"]
    recs, scan, state, _ = got["port"]
    rep = state["report"]
    assert (rep["torn_tail_truncated"] == 1) == (how == "torn")
    assert (rep["corrupt_quarantined"] >= 1) == (how == "bitflip")
    assert rep["ckpt_quarantined"] == (how == "stale")
    if how in ("clean", "torn", "stale"):
        assert rep["ckpt_lsn"] > 0 and 77 not in state["sessions"]
        assert state["sessions"][0]["tokens"] == [7, 8, 1]
    if how == "clean":
        # the checkpoint's snapshot (0, 5) and the suffix (6; 5 ends)
        assert sorted(state["sessions"]) == [0, 6]
        assert state["grammars"] == {"g0": {"n": [0]}}


def _abandon(side, wd, jobs, steps, kv=None, **sup_kw):
    sup = MODS[side].EngineSupervisor(_factory(side, kv), wal_dir=wd,
                                      **SUP_KW, **sup_kw)
    reqs = [sup.submit(p, max_new_tokens=m) for p, m in jobs]
    for _ in range(steps):
        sup.step()
    return [(r.rid, list(map(int, r.tokens))) for r in reqs]


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_cold_restart_crosses_packages(tmp_path, writer, reader):
    """A supervisor of ``writer`` dies mid-decode; ``reader``'s
    ``recover_from_disk`` finishes every session token-identical to
    the JAX engine's uninterrupted run, keeping what was on disk."""
    jobs = list(zip(_prompts([12, 5, 20], seed=1), [5, 6, 4]))
    want = _refs("jax", jobs)
    wd = str(tmp_path / "j")
    before = _abandon(writer, wd, jobs, 5, checkpoint_every=4)
    assert any(t for _, t in before)
    sup2 = MODS[reader].EngineSupervisor.recover_from_disk(
        _factory(reader), wd, **SUP_KW)
    assert sorted(sup2.restored) == [rid for rid, _ in before]
    for rid, toks in before:
        assert list(sup2.restored[rid].tokens) == toks[
            :len(sup2.restored[rid].tokens)]
    sup2.run()
    for (rid, _), ref in zip(before, want):
        out = sup2.restored[rid]
        assert out.finish_reason in ("eos", "max_len")
        np.testing.assert_array_equal(np.asarray(out.output), ref)
    assert sup2.wal.lsn > 0


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_checkpoint_prefix_crosses_packages(tmp_path, writer, reader):
    """``checkpoint_prefix=True`` in one package, a cold restart in the
    other: the restored trie matches the writer's chain over
    byte-equal pages, and a new request on the prompt hits it with the
    JAX engine's tokens."""
    prompt = _prompts([16], seed=9)[0]
    wd = str(tmp_path / "j")
    sup = MODS[writer].EngineSupervisor(_factory(writer), wal_dir=wd,
                                        checkpoint_prefix=True, **SUP_KW)
    r = sup.submit(prompt, max_new_tokens=2)
    sup.run()
    assert r.done
    sup.checkpoint_now()
    chain, _ = sup.engine.cache.prefix.match(prompt)
    assert len(chain) >= 1
    del sup
    saved = WALS[reader].recover_state(wd, repair=False)["prefix"]
    sup2 = MODS[reader].EngineSupervisor.recover_from_disk(
        _factory(reader), wd, **SUP_KW)
    cache = sup2.engine.cache
    matched, _ = cache.prefix.match(prompt)
    assert len(matched) == len(chain)
    old = {p: i for i, p in enumerate(saved["page_ids"])}
    for name, arr in saved["arrays"].items():
        pool = np.asarray(cache.pool[name])
        for new_page, old_page in zip(matched, chain):
            np.testing.assert_array_equal(pool[:, new_page],
                                          arr[:, old[old_page]])
    want = _refs("jax", [(prompt, 2)])[0]
    r2 = sup2.submit(prompt, max_new_tokens=2)
    sup2.run()
    np.testing.assert_array_equal(np.asarray(r2.output), want)


def test_generator_state_rides_the_log(tmp_path):
    """A sampled port engine journals ``torch.Generator`` state under
    ``gen_state``: the port installs the last one at a cold restart,
    the JAX fold skips it (no ``key``), and the sessions finish."""
    jobs = list(zip(_prompts([6, 9], seed=2), [6, 6]))
    wd = str(tmp_path / "j")
    make = _factory("port", temperature=0.8)
    sup = tserving.EngineSupervisor(make, wal_dir=wd, checkpoint_every=3,
                                    **SUP_KW)
    reqs = [sup.submit(p, max_new_tokens=m) for p, m in jobs]
    for _ in range(4):
        sup.step()
    last = sup._key_data.copy()
    del sup
    st = twal.recover_state(wd, repair=False)
    np.testing.assert_array_equal(st["gen_state"], last)
    assert jwal.recover_state(wd, repair=False)["key_data"] is None
    sup2 = tserving.EngineSupervisor.recover_from_disk(make, wd, **SUP_KW)
    np.testing.assert_array_equal(
        sup2.engine.generator.get_state().numpy(), last)
    sup2.run()
    assert all(len(sup2.restored[r.rid].tokens) == 6 for r in reqs)


# ----------------------------------- the reference's contracts, port only

def _port(kv=None, **kw):
    return _factory("port", kv, **kw)


class TestWalUnit:
    def test_frame_roundtrip_and_reopen(self, tmp_path):
        d = str(tmp_path)
        w = twal.WriteAheadLog(d, group_interval_s=0.0)
        l1 = w.append("submit", {"rid": 1, "tokens": []})
        l2 = w.append("step", {"rid": 1, "toks": [7, 8]})
        w.commit(force=True)
        w.close()
        w2 = twal.WriteAheadLog(d)
        assert w2.lsn == l2 == l1 + 1
        w2.append("finish", {"rid": 1, "reason": "eos"})
        w2.commit(force=True)
        w2.close()
        recs, report = twal.scan_segments(d, repair=False)
        assert [r["kind"] for r in recs] == ["submit", "step", "finish"]
        assert [r["lsn"] for r in recs] == [1, 2, 3]
        assert report["torn_tail_truncated"] == 0
        assert len(_segs(d)) == 2

    def test_segment_rotation_and_checkpoint_pruning(self, tmp_path):
        d = str(tmp_path)
        w = twal.WriteAheadLog(d, segment_bytes=256, group_interval_s=0.0)
        for i in range(20):
            w.append("submit", {"rid": i, "prompt": [3] * 10,
                                "max_new_tokens": 2, "tokens": [],
                                "admitted": False})
        before = _segs(d)
        assert len(before) > 2
        w.checkpoint({"sessions": [{"rid": 99, "prompt": [4],
                                    "max_new_tokens": 1,
                                    "tokens": [5], "admitted": True}],
                      "next_rid": 100})
        assert len(_segs(d)) < len(before)
        w.append("submit", {"rid": 100, "prompt": [6],
                            "max_new_tokens": 1, "tokens": [],
                            "admitted": False})
        w.commit(force=True)
        w.close()
        state = twal.recover_state(d)
        assert 99 in state["sessions"] and 100 in state["sessions"]
        assert state["sessions"][99]["tokens"] == [5]
        assert state["next_rid"] >= 101
        assert state["report"]["ckpt_lsn"] == 20

    def test_torn_tail_truncated_at_last_valid_frame(self, tmp_path):
        d = str(tmp_path)
        w = twal.WriteAheadLog(d, group_interval_s=0.0)
        for i in range(4):
            w.append("submit", {"rid": i, "tokens": []})
        w.commit(force=True)
        w.close()
        seg = os.path.join(d, _segs(d)[0])
        with open(seg, "r+b") as f:
            f.truncate(os.path.getsize(seg) - 7)
        state = twal.recover_state(d)
        assert sorted(state["sessions"]) == [0, 1, 2]
        assert state["report"]["torn_tail_truncated"] == 1
        recs, rep2 = twal.scan_segments(d, repair=False)
        assert len(recs) == 3 and rep2["torn_tail_truncated"] == 0

    def test_bitflip_quarantines_suffix(self, tmp_path):
        d = str(tmp_path)
        w = twal.WriteAheadLog(d, segment_bytes=128, group_interval_s=0.0)
        for i in range(10):
            w.append("submit", {"rid": i, "tokens": []})
        w.commit(force=True)
        w.close()
        segs = _segs(d)
        assert len(segs) >= 3
        _damage(d, "bitflip")
        state = twal.recover_state(d)
        assert state["report"]["corrupt_quarantined"] >= 1
        first = [r["rid"] for r in twal.scan_segments(d, repair=False)[0]]
        assert sorted(state["sessions"]) == sorted(first)
        assert any(f.endswith(".quarantined") for f in os.listdir(d))

    def test_stale_checkpoint_never_installed(self, tmp_path):
        d = str(tmp_path)
        w = twal.WriteAheadLog(d, group_interval_s=0.0)
        for i in range(3):
            w.append("submit", {"rid": i, "tokens": []})
        w.commit(force=True)
        w.close()
        _damage(d, "stale")
        state = twal.recover_state(d)
        assert 77 not in state["sessions"]
        assert sorted(state["sessions"]) == [0, 1, 2]
        assert state["report"]["ckpt_quarantined"] == 1
        assert not os.path.exists(os.path.join(d, twal._ckpt_name(999)))

    def test_corrupt_checkpoint_falls_back(self, tmp_path):
        d = str(tmp_path)
        w = twal.WriteAheadLog(d, group_interval_s=0.0)
        for i in range(2):
            w.append("submit", {"rid": i, "tokens": []})
        w.checkpoint({"sessions": [], "next_rid": 2})
        ck = [f for f in os.listdir(d) if f.startswith("ckpt-")][0]
        full = os.path.join(d, ck)
        data = open(full, "rb").read()
        open(full, "wb").write(data[:len(data) // 2])
        w.append("submit", {"rid": 5, "tokens": []})
        w.commit(force=True)
        w.close()
        state = twal.recover_state(d)
        assert state["report"]["ckpt_quarantined"] == 1
        assert sorted(state["sessions"]) == [0, 1, 5]

    def test_tamper_latches_log_dead(self, tmp_path):
        d = str(tmp_path)
        w = twal.WriteAheadLog(d, group_interval_s=0.0)
        w.append("submit", {"rid": 0, "tokens": []})
        inj = tserving.FaultInjector(seed=0)
        inj.arm_tamper("wal_append", nth=1)
        with inj:
            with pytest.raises(tserving.InjectedFault):
                w.append("step", {"rid": 0, "toks": [4]})
        with pytest.raises(twal.WalTorn):
            w.append("step", {"rid": 0, "toks": [5]})
        state = twal.recover_state(d)
        assert sorted(state["sessions"]) == [0]
        assert state["sessions"][0]["tokens"] == []
        assert state["report"]["torn_tail_truncated"] == 1

    def test_fsync_policy_validated(self, tmp_path):
        with pytest.raises(ValueError, match="fsync"):
            twal.WriteAheadLog(str(tmp_path), fsync="sometimes")


class TestRecoverFromDisk:
    @pytest.mark.parametrize("kv", [None, "int8"], ids=["f32", "int8"])
    def test_cold_restart_token_identity(self, kv, tmp_path):
        factory = _port(kv)
        jobs = list(zip(_prompts([12, 5, 20], seed=1), [5, 6, 4]))
        refs = _refs("port", jobs, kv)
        wd = str(tmp_path / "j")
        sup = tserving.EngineSupervisor(factory, wal_dir=wd,
                                        checkpoint_every=4, **SUP_KW)
        reqs = [sup.submit(p, max_new_tokens=m) for p, m in jobs]
        for _ in range(5):
            sup.step()
        del sup
        sup2 = tserving.EngineSupervisor.recover_from_disk(factory, wd,
                                                           **SUP_KW)
        assert sorted(sup2.restored) == [r.rid for r in reqs]
        sup2.run()
        for req, ref in zip(reqs, refs):
            out = sup2.restored[req.rid]
            assert out.finish_reason in ("eos", "max_len")
            np.testing.assert_array_equal(out.output, ref)
        assert sup2.wal.lsn > 0
        assert sup2.load_stats()["wal"]["lsn"] == sup2.wal.lsn

    def test_geometry_mismatch_rejected(self, tmp_path):
        wd = str(tmp_path / "j")
        sup = tserving.EngineSupervisor(_port(), wal_dir=wd, **SUP_KW)
        sup.submit(_prompts([6])[0], max_new_tokens=2)
        sup.step()
        del sup
        other = lambda: tc._engine("port", page_size=16)  # noqa: E731
        with pytest.raises(ValueError, match="page_size"):
            tserving.EngineSupervisor.recover_from_disk(other, wd,
                                                        **SUP_KW)
        # the refused attempt left the dead engine's geometry on top
        assert twal.recover_state(wd)["geometry"]["page_size"] == 8
        sup2 = tserving.EngineSupervisor.recover_from_disk(_port(), wd,
                                                           **SUP_KW)
        assert len(sup2.restored) == 1

    def test_swapped_session_recovers_by_replay(self, tmp_path):
        factory = _port(host_tier=True)
        jobs = list(zip(_prompts([10, 8], seed=3), [10, 10]))
        refs = _refs("port", jobs, host_tier=True)
        wd = str(tmp_path / "j")
        sup = tserving.EngineSupervisor(factory, wal_dir=wd, **SUP_KW)
        reqs = [sup.submit(p, max_new_tokens=m) for p, m in jobs]
        for _ in range(4):
            sup.step()
        hp = sup.submit(_prompts([4], seed=4)[0], max_new_tokens=2,
                        priority=tserving.Priority.HIGH)
        for _ in range(2):
            sup.step()
        sup._sync_journal(force=True)
        sup.wal.commit(force=True)
        assert [e.rid for e in sup.journal.live_entries() if e.swapped]
        del sup
        sup2 = tserving.EngineSupervisor.recover_from_disk(factory, wd,
                                                           **SUP_KW)
        assert any(r.swapped for r in sup2.restored.values())
        sup2.run()
        assert sup2.engine.cache.swap_replay_fallbacks >= 1
        for req, ref in zip(reqs, refs):
            out = sup2.restored.get(req.rid, req)
            np.testing.assert_array_equal(out.output, ref)
        assert (hp.done and hp.finish_reason in ("eos", "max_len")
                or sup2.restored[hp.rid].done)

    def test_constrained_session_recovers_always_valid(self, tmp_path):
        factory = _port(constraints=True, eos_token_id=2)
        cfg = ts._models()["port"][4]
        dfa = tserving.dfa_from_sequences([[4, 5, 6, 7, 8, 9]],
                                          cfg.vocab_size)
        p = _prompts([5], seed=5)[0]
        ref_eng = factory()
        ref = ref_eng.submit(p, max_new_tokens=5, constraint=dfa)
        ref_eng.run()
        wd = str(tmp_path / "j")
        sup = tserving.EngineSupervisor(factory, wal_dir=wd, **SUP_KW)
        r = sup.submit(p, max_new_tokens=5, constraint=dfa)
        for _ in range(4):
            sup.step()
        assert r.tokens and not r.done
        del sup
        with pytest.raises(ValueError, match="constraints=True"):
            tserving.EngineSupervisor.recover_from_disk(_port(), wd,
                                                        **SUP_KW)
        sup2 = tserving.EngineSupervisor.recover_from_disk(factory, wd,
                                                           **SUP_KW)
        r2 = sup2.restored[r.rid]
        assert r2.constraint is not None
        sup2.run()
        np.testing.assert_array_equal(r2.output, ref.output)

    def test_checkpoint_prefix_restores_trie(self, tmp_path):
        factory = _port()
        wd = str(tmp_path / "j")
        sup = tserving.EngineSupervisor(factory, wal_dir=wd,
                                        checkpoint_prefix=True, **SUP_KW)
        prompt = _prompts([16], seed=9)[0]
        r = sup.submit(prompt, max_new_tokens=2)
        sup.run()
        assert r.done
        sup.checkpoint_now()
        del sup
        sup2 = tserving.EngineSupervisor.recover_from_disk(factory, wd,
                                                           **SUP_KW)
        matched, _ = sup2.engine.cache.prefix.match(prompt)
        assert len(matched) >= 1
        ref = factory().generate([prompt], max_new_tokens=2)[0]
        r2 = sup2.submit(prompt, max_new_tokens=2)
        sup2.run()
        np.testing.assert_array_equal(r2.output, ref)

    def test_deadline_survives_restore_then_crash(self, tmp_path):
        t = [0.0]
        clock = lambda: t[0]                # noqa: E731
        factory = _port()
        wd = str(tmp_path / "j1")
        sup = tserving.EngineSupervisor(factory, wal_dir=wd, clock=clock,
                                        **SUP_KW)
        r = sup.submit(_prompts([10], seed=10)[0], max_new_tokens=8,
                       deadline_s=100.0)
        sup.step()
        path = str(tmp_path / "drain.npz")
        sup.drain(path)
        wd2 = str(tmp_path / "j2")
        sup2 = tserving.EngineSupervisor.restore(factory, path,
                                                 wal_dir=wd2, clock=clock,
                                                 **SUP_KW)
        assert sup2.restored[r.rid].deadline_at is not None
        sup2.step()
        del sup2
        sup3 = tserving.EngineSupervisor.recover_from_disk(
            factory, wd2, clock=clock, **SUP_KW)
        assert sup3.restored[r.rid].deadline_at is not None

    def test_drained_dir_resurrects_nothing(self, tmp_path):
        factory = _port()
        wd = str(tmp_path / "j")
        sup = tserving.EngineSupervisor(factory, wal_dir=wd, **SUP_KW)
        sup.submit(_prompts([10], seed=6)[0], max_new_tokens=6)
        for _ in range(3):
            sup.step()
        sup.drain(str(tmp_path / "drain.npz"))
        sup2 = tserving.EngineSupervisor.recover_from_disk(factory, wd,
                                                           **SUP_KW)
        assert sup2.restored == {}


class TestHostStoreDiskBound:
    def test_max_disk_bytes_prunes_lru(self, tmp_path):
        d = str(tmp_path / "store")
        store = tserving.HostPageStore(page_size=8, path=d,
                                       max_disk_bytes=1)
        keys = []
        for i in range(4):
            key = bytes([i]) * 8
            keys.append(key)
            store.put(key, {"k": np.full((2, 1, 8), i, np.float32)},
                      persist=True)
            assert len([f for f in os.listdir(d)
                        if f.endswith(".npz")]) == 1
        assert store.disk_pruned_total == 3
        assert store.disk_pruned_bytes_total > 0
        assert store.stats()["disk_pruned_total"] == 3
        fresh = tserving.HostPageStore(page_size=8, path=d)
        assert fresh.get(keys[-1]) is not None
        assert fresh.get(keys[0]) is None

    def test_unbounded_by_default(self, tmp_path):
        d = str(tmp_path / "store")
        store = tserving.HostPageStore(page_size=8, path=d)
        for i in range(3):
            store.put(bytes([i]) * 4,
                      {"k": np.zeros((2, 1, 8), np.float32)},
                      persist=True)
        assert len([f for f in os.listdir(d) if f.endswith(".npz")]) == 3
        assert store.disk_pruned_total == 0

    def test_validation(self):
        with pytest.raises(ValueError, match="max_disk_bytes"):
            tserving.HostPageStore(page_size=8, max_disk_bytes=0)


# ------------------------------------------------------ the crash sweep

class _ProcessDied(RuntimeError):
    """The simulated ``kill -9``: raised instead of the supervisor's
    in-process recovery; the supervisor object is then abandoned (no
    drain) and a fresh one recovers from the directory alone."""


def _crashy(sup):
    """Make ``sup`` die instead of recovering."""
    def die(err):
        raise _ProcessDied(f"{type(err).__name__}: {err}") from err
    sup._on_failure = die
    return sup


_ENVS = {}


def _sweep_env(kv=None, constrained=False, tree=False, overlap=False):
    """One sweep environment (the port copy of the reference chaos
    tool's ``_sweep_env``): an engine factory with the host tier and a
    two-slot adapter pool, plus an always-draft speculator, or a draft
    tree (``tree``: ``draft_propose`` / ``tree_verify``), or grammar
    constraints (``constrained``); the jobs that visit every site; and
    each job's uninterrupted run on the same engine."""
    key = (kv, constrained, tree, overlap)
    if key in _ENVS:
        return _ENVS[key]
    E, _, _, params, cfg, extra = ts._models()["port"]
    registry = tserving.AdapterRegistry(cfg)
    for aid in (1, 2, 3):
        registry.register(aid, tserving.init_lora(cfg, 4, seed=300 + aid))
    dfa = (tserving.dfa_from_sequences(
        [[4, 5, 6, 7, 8, 9], [4, 5, 6, 3, 3, 3]], cfg.vocab_size)
        if constrained else None)

    def factory():
        kw = dict(max_batch=2, page_size=8, max_len=48, prefill_chunk=8,
                  kv_cache_dtype=kv, host_tier=True, overlap=overlap,
                  adapters=dict(slots=2, rank=4, registry=registry,
                                store=tserving.HostPageStore(page_size=8)))
        if constrained:
            kw["constraints"] = True
        elif tree:
            kw.update(spec_k=2, draft_layers=1, spec_tree=(2, 2))
        else:
            kw.update(spec_k=2, speculator=tr._repeat_last(tserving, 2))
        return E(params, cfg, **kw, **extra)

    rs = np.random.RandomState(7)
    motif = rs.randint(3, cfg.vocab_size, (3,))
    P = tserving.Priority
    # a long chunked prefill, a speculative motif, adapter churn over
    # the two-slot pool, then a HIGH one that preempts a decode-phase
    # victim through the swap pair
    jobs = [
        (rs.randint(3, cfg.vocab_size, (18,)).astype(np.int32), 4,
         P.NORMAL, 1, None),
        (np.tile(motif, 5).astype(np.int32)[:14], 5, P.NORMAL, 2, dfa),
        (rs.randint(3, cfg.vocab_size, (6,)).astype(np.int32), 5,
         P.NORMAL, 3, None),
        (rs.randint(3, cfg.vocab_size, (5,)).astype(np.int32), 4,
         P.NORMAL, 1, None),
        (rs.randint(3, cfg.vocab_size, (4,)).astype(np.int32), 2,
         P.HIGH, 0, None),
        (rs.randint(3, cfg.vocab_size, (7,)).astype(np.int32), 4,
         P.NORMAL, 0, None),
    ]
    ref_engine = factory()
    refs = []
    for p, m, _prio, aid, con in jobs:
        r = ref_engine.submit(p, max_new_tokens=m, adapter_id=aid,
                              constraint=con)
        ref_engine.run()
        refs.append(np.asarray(r.output))
    _ENVS[key] = (factory, jobs, refs)
    return _ENVS[key]


def _drive(sup, factory, wd, sup_kw, inj, job_stream, max_steps):
    """Submit the jobs two steps apart and step to the end; each
    simulated death recovers from ``wd``. Returns the final handles by
    job index, the deaths and the last supervisor."""
    state = {"sup": sup, "deaths": 0}
    job_of, cur = {}, {}

    def recover():
        state["deaths"] += 1
        state["sup"] = _crashy(tserving.EngineSupervisor.recover_from_disk(
            factory, wd, **sup_kw))
        cur.update(state["sup"].restored)

    def step():
        try:
            return state["sup"].step()
        except _ProcessDied:
            recover()
            return True

    steps = 0
    with inj:
        for i, (p, m, prio, aid, con) in job_stream:
            while True:
                try:
                    r = state["sup"].submit(p, max_new_tokens=m,
                                            priority=prio,
                                            adapter_id=aid,
                                            constraint=con)
                    job_of[r.rid] = i
                    cur[r.rid] = r
                    break
                except (tserving.InjectedFault, _ProcessDied):
                    # the write-ahead append died before the ack: the
                    # client never got a handle and submits again
                    recover()
            for _ in range(2):
                step()
                steps += 1
        while step():
            steps += 1
            assert steps < max_steps, "the run did not drain"
    by_job = {}
    for rid, j in job_of.items():
        by_job.setdefault(j, []).append(cur[rid])
    return by_job, state["deaths"], state["sup"]


def _check_end(sup, by_job, refs, deaths, wd, n_jobs):
    """No request lost or duplicated, tokens equal to the uninterrupted
    run, one CRC-clean flight dump a death, allocators and pins
    balanced."""
    assert sum(len(v) for v in by_job.values()) == n_jobs
    for j, handles in by_job.items():
        for req in handles:
            assert req.done and req.finish_reason in ("eos", "max_len"), (
                j, req.finish_reason)
            np.testing.assert_array_equal(np.asarray(req.output), refs[j])
    dumps = tflight.find_dumps(wd)
    assert len(dumps) >= deaths
    for dp in dumps:
        tflight.load(dp)
    eng = sup.engine
    ts._assert_balanced(eng)
    if eng.draft_cache is not None:
        assert eng.draft_cache.allocator.num_used == 0
    if eng.adapters is not None:
        assert all(n == 0 for n in eng.adapters._pins.values())


def _crash_at(site, env, wd, checkpoint_every=3):
    factory, jobs, refs = env
    sup_kw = dict(backoff_s=0.0, sleep=lambda s: None,
                  circuit_threshold=50, checkpoint_every=checkpoint_every,
                  wal_kw=dict(group_interval_s=0.0))
    sup = _crashy(tserving.EngineSupervisor(factory, wal_dir=wd,
                                            **sup_kw))
    inj = tserving.FaultInjector(seed=0)
    # the swap-in's bounded retry absorbs single shots: exhaust it
    shots = (sup.engine.cache.swap_in_retries + 1
             if site == "swap_in" else 1)
    for k in range(shots):
        inj.arm(site, "raise", nth=k + 1)
    by_job, deaths, sup = _drive(sup, factory, wd, sup_kw, inj,
                                 list(enumerate(jobs)), 400)
    assert inj.fired[site] >= 1, f"{site} never fired"
    assert deaths >= 1, f"{site} fired but the process never died"
    _check_end(sup, by_job, refs, deaths, wd, len(jobs))


@pytest.mark.parametrize("site", tres.ENGINE_SITES)
def test_crash_point_sweep(tmp_path, site):
    """Process death at ``site``, then ``recover_from_disk``."""
    tree = site in ("draft_propose", "tree_verify")
    _crash_at(site, _sweep_env(tree=tree), str(tmp_path / site))


@pytest.mark.parametrize("site", ["decode_step", "prefill_chunk",
                                  "swap_in", "wal_append",
                                  "checkpoint_write"])
def test_crash_point_sweep_int8(tmp_path, site):
    _crash_at(site, _sweep_env(kv="int8"), str(tmp_path / site))


@pytest.mark.parametrize("site", ["decode_step", "prefill_chunk",
                                  "adapter_load", "wal_append",
                                  "wal_fsync", "checkpoint_write"])
def test_crash_point_sweep_constrained_and_adapters(tmp_path, site):
    """Mid-grammar and adapter-pinned sessions on the same gate (a
    constrained engine takes no speculation)."""
    _crash_at(site, _sweep_env(constrained=True), str(tmp_path / site))


def test_crash_point_sweep_overlapped(tmp_path):
    """The overlapped pipeline: a forward is in flight when the log
    appends, and its tokens must not reach a frame before the commit
    fetched them: deaths at the two seams and at an append recover
    token-identically."""
    env = _sweep_env(overlap=True)
    for site in ("dispatch", "commit", "wal_append"):
        _crash_at(site, env, str(tmp_path / site))


def test_crash_soak(tmp_path):
    """A seeded stream of the sweep's jobs (three rounds) with kills
    armed at random frequently visited sites, one a torn write."""
    factory, jobs, refs = _sweep_env()
    wd = str(tmp_path / "journal")
    sup_kw = dict(backoff_s=0.0, sleep=lambda s: None,
                  circuit_threshold=50, checkpoint_every=4,
                  wal_kw=dict(group_interval_s=0.0))
    sup = _crashy(tserving.EngineSupervisor(factory, wal_dir=wd, **sup_kw))
    rs = np.random.RandomState(0)
    inj = tserving.FaultInjector(seed=0)
    kill_sites = ["decode_step", "prefill_chunk", "sched_tick", "transfer",
                  "dispatch", "commit", "wal_append", "wal_fsync",
                  "checkpoint_write"]
    n = 3 * len(jobs)

    def stream():
        """The jobs, a kill armed before the 2nd, 6th and 10th (the
        last a torn write)."""
        for i in range(n):
            if i in (1, 5):
                inj.arm(str(rs.choice(kill_sites)), "raise",
                        nth=int(rs.randint(1, 6)))
            elif i == 9:
                inj.arm_tamper("wal_append", nth=int(rs.randint(1, 4)))
            yield i % len(jobs), jobs[i % len(jobs)]

    by_job, deaths, sup = _drive(sup, factory, wd, sup_kw, inj, stream(),
                                 2000)
    assert deaths >= 1 and inj.fired["wal_append"] >= 1
    _check_end(sup, by_job, refs, deaths, wd, n)
