"""The durable journal of the serving plane: the on-disk write-ahead
log under :class:`~paddle_tpu_torch.serving.RequestJournal`.

The port's counterpart of ``paddle_tpu/serving/wal.py``. The in-memory
journal survives a failed step but not the process: a ``kill -9``, an
OOM kill or a host reboot loses every live session. This module moves
the source of truth to disk:

- :class:`WriteAheadLog` — a SEGMENTED append-only log of CRC-framed
  JSON records (``MAGIC | payload_len | crc32 | payload``). Admission
  params land on disk at submit time (write-ahead); committed tokens,
  generator snapshots, adapter pins, constraint state and the
  preempt / swap / handoff ownership transitions land at each journal
  sync. The fsync ladder: ``"commit"`` fsyncs every append (an acked
  submission survives host power loss), ``"group"`` flushes every
  commit boundary to the OS and fsyncs once a ``group_interval_s``
  window (default 250 ms: process death loses nothing flushed, power
  loss up to one window), ``"off"`` flushes to the OS only. A failed
  append rolls the file back to the last frame boundary, so only real
  process death leaves a torn tail.

- **incremental checkpoints** — :meth:`WriteAheadLog.checkpoint`
  writes the journal snapshot as one atomic ``ckpt-<lsn>.npz`` (the
  drain ``.npz`` layout with per-array CRC32s) without stopping
  admissions, then prunes every log segment the oldest kept checkpoint
  covers: recovery is snapshot + log-suffix replay, so the log does not
  grow with served traffic.

- :func:`recover_state` — the cold-restart scan: the newest VALID
  checkpoint (a torn or corrupt one, or one claiming an lsn the log
  never reached, is quarantined and counted), a torn WAL tail truncated
  at the last valid frame, every segment past a corrupt mid-log frame
  quarantined (replaying past a hole would install wrong state), and
  the surviving records folded into per-session state for
  :meth:`~paddle_tpu_torch.serving.EngineSupervisor.recover_from_disk`.

The on-disk format is the JAX package's byte for byte (magic, header,
JSON separators, file names, checkpoint array names and CRCs), so a
directory either package wrote recovers in the other. One record
differs: the JAX package journals its PRNG key (a ``key`` record, a
``key_data`` checkpoint array), which a ``torch.Generator`` cannot
take, and the port journals ``torch.Generator.get_state()`` under a
kind and an array name of its own (``gen_state``), which the JAX
package's fold skips as it skips every kind it does not know. Each
package ignores the other's generator record. A greedy session
therefore recovers token-identically in either package; a sampled one
keeps its step-granular stream only within the package that wrote it.

Fault sites: ``wal_append`` fires BEFORE a frame is written (nothing
commits), ``wal_fsync`` before the fsync, ``checkpoint_write`` before
the checkpoint file is produced. The ``wal_append`` TAMPER mode writes
half a frame and latches the log dead: a process dying mid-write.
"""
from __future__ import annotations

import base64
import json
import os
import struct
import time
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..observability import hooks as _obs
from .resilience import (InjectedFault, _np_dtype, fault_point,
                         payload_checksums, tamper_point,
                         verify_checksums)

#: frame header: magic, payload length, payload crc32
MAGIC = b"PTWL"
_HDR = struct.Struct("<4sII")

FSYNC_POLICIES = ("commit", "group", "off")

#: the record kind and checkpoint array of the port's generator state
GEN_STATE = "gen_state"


class WalTorn(RuntimeError):
    """The log latched dead after a simulated torn write (the
    ``wal_append`` tamper mode models a process dying mid-frame; a
    'process' that kept appending after its own death would be a
    simulation bug, so further appends raise this)."""


def _seg_name(start_lsn: int) -> str:
    return f"wal-{start_lsn:016d}.log"


def _ckpt_name(lsn: int) -> str:
    return f"ckpt-{lsn:016d}.npz"


def _encode_frame(record: Dict) -> bytes:
    data = json.dumps(record, separators=(",", ":")).encode()
    return _HDR.pack(MAGIC, len(data), zlib.crc32(data) & 0xFFFFFFFF) \
        + data


def _geometry(rec: Dict) -> Dict:
    return {k: rec.get(k) for k in ("page_size", "max_len", "max_batch",
                                    "kv_dtype", "constraints", "draft")}


class WriteAheadLog:
    """Segmented CRC-framed append-only log + incremental checkpoints.

    ``path`` is one journal directory (one per supervisor). Records are
    JSON dicts stamped with a monotonically increasing ``lsn``; opening
    an existing directory repairs and scans it (or trusts ``last_lsn``
    from a :func:`recover_state` that just did) and continues the
    sequence in a FRESH segment, so two generations never interleave
    frames in one file.
    """

    def __init__(self, path: str, *, fsync: str = "group",
                 segment_bytes: int = 1 << 20,
                 group_interval_s: float = 0.25,
                 clock=time.monotonic,
                 last_lsn: Optional[int] = None):
        if fsync not in FSYNC_POLICIES:
            raise ValueError(
                f"WriteAheadLog: fsync={fsync!r} not in "
                f"{FSYNC_POLICIES}")
        self.path = path
        self.fsync = fsync
        self.segment_bytes = int(segment_bytes)
        self.group_interval_s = float(group_interval_s)
        self._clock = clock
        os.makedirs(path, exist_ok=True)
        if last_lsn is not None:
            # the caller just ran recover_state() on this directory:
            # the scan is paid once
            self._lsn = int(last_lsn)
        else:
            # repair at open: a torn tail from a prior crash truncates
            # NOW, before this generation appends, so that no valid
            # segment ever sits beyond a tear
            _records, report = scan_segments(path, repair=True)
            self._lsn = report["last_lsn"]
        self._f = None
        self._seg_path: Optional[str] = None
        self._dirty = False           # bytes flushed but not fsynced
        self._last_fsync = -1e9
        self._last_delta = -1e9
        self._torn = False
        self.appends_total = 0
        self.bytes_total = 0
        self.fsyncs_total = 0
        self.checkpoints_total = 0
        self.segments_pruned_total = 0
        #: host nanoseconds spent appending / fsyncing
        self.append_ns = 0
        self.fsync_ns = 0

    # ---- segment management ----
    def _open_segment(self):
        self._seg_path = os.path.join(self.path,
                                      _seg_name(self._lsn + 1))
        self._f = open(self._seg_path, "ab")

    def _ensure_segment(self, frame_len: int):
        if self._f is None:
            self._open_segment()
            return
        if self._f.tell() + frame_len > self.segment_bytes \
                and self._f.tell() > 0:
            # rotate; fsync the retiring segment first, so a pruned or
            # recovered log never depends on an unfsynced old file
            if self.fsync != "off" and self._dirty:
                self._fsync()
            self._f.close()
            self._open_segment()

    # ---- append / commit ----
    def append(self, kind: str, payload: Dict,
               flush: bool = False) -> int:
        """Append one record; returns its lsn. The fault site fires
        BEFORE anything is written, and a write failure rolls the file
        back to the previous frame boundary. Frames reach the OS at the
        next :meth:`commit` (one a step); ``flush=True`` pushes them
        now, the ACK path of a write-ahead submit record."""
        if self._torn:
            raise WalTorn(
                "WriteAheadLog: log latched dead after a simulated "
                "torn write — recover_state() owns this directory now")
        fault_point("wal_append")
        t0 = time.perf_counter_ns()
        rec = dict(payload)
        rec["lsn"] = self._lsn + 1
        rec["kind"] = kind
        frame = _encode_frame(rec)
        self._ensure_segment(len(frame))
        pos = self._f.tell()
        if tamper_point("wal_append"):
            # torn-write simulation: half a frame reaches the OS, then
            # the 'process dies'; recovery truncates at the last frame
            self._f.write(frame[:max(1, len(frame) // 2)])
            self._f.flush()
            self._torn = True
            raise InjectedFault(
                "wal_append", "tamper",
                "torn frame write (simulated mid-append process death)")
        try:
            self._f.write(frame)
            if flush or self.fsync == "commit":
                self._f.flush()
        except BaseException:
            try:
                self._f.seek(pos)
                self._f.truncate()
            except OSError:
                pass
            raise
        self._lsn = rec["lsn"]
        self._dirty = True
        self.appends_total += 1
        self.bytes_total += len(frame)
        self.append_ns += time.perf_counter_ns() - t0
        _obs.serving_wal_append(t0, len(frame))
        if self.fsync == "commit":
            self._fsync()
        return self._lsn

    def commit(self, force: bool = False) -> bool:
        """The group-commit boundary (one call a step): flush buffered
        frames to the OS; under ``"group"`` also fsync when the window
        (``group_interval_s``; 0 = every boundary) has lapsed.
        ``force`` fsyncs whatever the policy: the drain / close path.
        Returns True when an fsync ran."""
        if not self._dirty or self._f is None:
            return False
        self._f.flush()
        if force or (self.fsync == "group"
                     and (self._clock() - self._last_fsync
                          >= self.group_interval_s)):
            self._fsync()
            return True
        return False

    def delta_due(self) -> bool:
        """Is a step-delta append pass due? Under ``"commit"`` (or a
        zero window) every step appends; under ``"group"`` / ``"off"``
        the deltas batch on the group window, since they are not
        durable before its fsync anyway."""
        return (self.fsync == "commit" or self.group_interval_s <= 0
                or (self._clock() - self._last_delta
                    >= self.group_interval_s))

    def mark_delta(self) -> None:
        self._last_delta = self._clock()

    def _fsync(self):
        fault_point("wal_fsync")
        t0 = time.perf_counter_ns()
        self._f.flush()
        os.fsync(self._f.fileno())
        self._dirty = False
        self._last_fsync = self._clock()
        self.fsyncs_total += 1
        self.fsync_ns += time.perf_counter_ns() - t0
        _obs.serving_wal_fsync(t0)

    def close(self):
        if self._f is not None:
            try:
                if self._dirty and self.fsync != "off":
                    self._fsync()
            except Exception:
                pass
            self._f.close()
            self._f = None

    # ---- checkpoints ----
    def checkpoint(self, meta: Dict,
                   arrays: Optional[Dict[str, np.ndarray]] = None
                   ) -> str:
        """Write one incremental checkpoint ``ckpt-<lsn>.npz`` (atomic
        tmp + rename; the drain ``.npz`` layout with per-array CRCs),
        then :meth:`_prune`. One host-side call between steps, not a
        drain."""
        fault_point("checkpoint_write")
        t0 = time.perf_counter_ns()
        meta = dict(meta)
        meta["wal_lsn"] = self._lsn
        arrays = dict(arrays or {})
        meta["checksums"] = payload_checksums(arrays)
        fn = os.path.join(self.path, _ckpt_name(self._lsn))
        tmp = fn + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, meta=np.frombuffer(
                json.dumps(meta).encode(), np.uint8), **arrays)
        os.replace(tmp, fn)
        self.checkpoints_total += 1
        pruned = self._prune(self._lsn, keep_ckpt=fn)
        _obs.serving_wal_checkpoint(t0, os.path.getsize(fn),
                                    len(meta.get("sessions", ())),
                                    pruned)
        return fn

    def _prune(self, ckpt_lsn: int, keep_ckpt: str) -> int:
        """Keep the new checkpoint and ONE fallback, then delete the log
        segments the OLDEST kept checkpoint covers (not the newest: the
        fallback is a fallback only while its log suffix exists). A
        segment named for its first lsn is covered when the NEXT
        segment starts at or below ``boundary + 1``."""
        cks = sorted(f for f in os.listdir(self.path)
                     if f.startswith("ckpt-") and f.endswith(".npz"))
        for old in cks[:-2]:
            if os.path.join(self.path, old) != keep_ckpt:
                try:
                    os.unlink(os.path.join(self.path, old))
                except OSError:
                    pass
        kept = sorted(int(f[5:-4]) for f in os.listdir(self.path)
                      if f.startswith("ckpt-") and f.endswith(".npz"))
        boundary = min(kept) if kept else ckpt_lsn
        pruned = 0
        segs = sorted(f for f in os.listdir(self.path)
                      if f.startswith("wal-") and f.endswith(".log"))
        starts = [int(s[4:-4]) for s in segs]
        for i, s in enumerate(segs):
            nxt = starts[i + 1] if i + 1 < len(starts) else None
            full = os.path.join(self.path, s)
            if (nxt is not None and nxt <= boundary + 1
                    and full != self._seg_path):
                try:
                    os.unlink(full)
                    pruned += 1
                except OSError:
                    pass
        self.segments_pruned_total += pruned
        return pruned

    @property
    def lsn(self) -> int:
        return self._lsn

    def stats(self) -> Dict:
        return {"lsn": self._lsn, "fsync_policy": self.fsync,
                "appends_total": self.appends_total,
                "bytes_total": self.bytes_total,
                "fsyncs_total": self.fsyncs_total,
                "checkpoints_total": self.checkpoints_total,
                "segments_pruned_total": self.segments_pruned_total,
                "append_ms_total": round(self.append_ns / 1e6, 3),
                "fsync_ms_total": round(self.fsync_ns / 1e6, 3)}


# ---------------- cold-restart scan / recovery ----------------

def scan_segments(path: str, repair: bool = True
                  ) -> Tuple[List[Dict], Dict]:
    """Read every frame of every segment in lsn order. A torn TAIL
    (short header or payload at the end of the written data) truncates
    at the last valid frame when ``repair`` is set; a corrupt frame
    with data after it (bit flip, foreign bytes) stops the scan there
    and quarantines the rest (that segment's tail truncates, later
    segments are renamed ``.quarantined``). Returns ``(records,
    report)`` with ``report = {last_lsn, torn_tail_truncated,
    corrupt_quarantined}``."""
    records: List[Dict] = []
    report = {"last_lsn": 0, "torn_tail_truncated": 0,
              "corrupt_quarantined": 0}
    if not os.path.isdir(path):
        return records, report
    segs = sorted(f for f in os.listdir(path)
                  if f.startswith("wal-") and f.endswith(".log"))
    stop = None                     # index of the segment that broke
    for i, seg in enumerate(segs):
        full = os.path.join(path, seg)
        with open(full, "rb") as f:
            data = f.read()
        pos = 0
        bad_at = None
        torn = False
        while pos < len(data):
            if pos + _HDR.size > len(data):
                bad_at, torn = pos, True    # torn header at the tail
                break
            magic, ln, crc = _HDR.unpack_from(data, pos)
            if pos + _HDR.size + ln > len(data):
                bad_at, torn = pos, True    # torn payload at the tail
                break
            body = data[pos + _HDR.size: pos + _HDR.size + ln]
            if magic != MAGIC \
                    or (zlib.crc32(body) & 0xFFFFFFFF) != crc:
                bad_at = pos        # corrupt frame (bit flip, foreign)
                break
            try:
                rec = json.loads(body.decode())
            except Exception:
                bad_at = pos
                break
            records.append(rec)
            report["last_lsn"] = max(report["last_lsn"],
                                     int(rec.get("lsn", 0)))
            pos += _HDR.size + ln
        if bad_at is not None:
            if torn:
                report["torn_tail_truncated"] += 1
            else:
                report["corrupt_quarantined"] += 1
            if repair:
                with open(full, "r+b") as f:
                    f.truncate(bad_at)
                _obs.serving_integrity("wal", "quarantined")
            stop = i
            break
    if stop is not None and stop + 1 < len(segs):
        # whole segments past the hole: replaying them would skip the
        # lost records
        for seg in segs[stop + 1:]:
            report["corrupt_quarantined"] += 1
            if repair:
                full = os.path.join(path, seg)
                try:
                    os.replace(full, full + ".quarantined")
                except OSError:
                    pass
                _obs.serving_integrity("wal", "quarantined")
    return records, report


def _load_checkpoint(path: str, fn: str) -> Optional[Dict]:
    """Decode and verify one checkpoint file; None when torn or
    corrupt."""
    full = os.path.join(path, fn)
    try:
        with np.load(full) as data:
            meta = json.loads(bytes(data["meta"]).decode())
            arrays = {n: np.asarray(data[n]) for n in data.files
                      if n != "meta"}
        verify_checksums(arrays, meta.get("checksums"), "wal_ckpt")
    except Exception:
        return None
    return {"meta": meta, "arrays": arrays, "file": full}


def _apply_delta(sessions: Dict, rec: Dict) -> None:
    """Fold one per-session step delta (or batched-frame entry) into
    the recovery state; an entry carrying ``fin`` retires the
    session."""
    rid = int(rec["rid"])
    if rec.get("fin") is not None:
        sessions.pop(rid, None)
        return
    s = sessions.get(rid)
    if s is None:
        return                      # finished before a stray delta
    s["tokens"] = list(s.get("tokens") or ()) \
        + list(rec.get("toks") or ())
    for k in ("preemptions", "swapped", "admitted"):
        if k in rec:
            s[k] = rec[k]
    if rec.get("cstate") is not None \
            and s.get("constraint") is not None:
        s["constraint"] = dict(s["constraint"], **rec["cstate"])


def recover_state(path: str, repair: bool = True) -> Dict:
    """The cold-restart recovery scan: newest valid checkpoint + WAL
    suffix replay, folded into per-session state.

    Returns ``{"sessions": {rid: rec}, "next_rid", "gen_state",
    "geometry", "grammars", "report"}`` (and ``"prefix"`` when a
    checkpoint carried the trie), each session rec in the
    :meth:`~.resilience.JournalEntry.as_record` shape. ``report``
    carries the media-fault counters (torn / quarantined frames,
    quarantined checkpoints) and the replayed record count."""
    state: Dict = {"sessions": {}, "next_rid": 0, "gen_state": None,
                   "geometry": None, "grammars": {}}
    records, report = scan_segments(path, repair=repair)
    report["ckpt_quarantined"] = 0
    ckpt_lsn = 0
    if os.path.isdir(path):
        cks = sorted((f for f in os.listdir(path)
                      if f.startswith("ckpt-") and f.endswith(".npz")),
                     reverse=True)
    else:
        cks = []
    for fn in cks:
        ck = _load_checkpoint(path, fn)
        stale = (ck is not None
                 and int(ck["meta"].get("wal_lsn", 0))
                 > report["last_lsn"] and records)
        if ck is not None and not stale:
            # log-suffix continuity: lsns are dense, so a record after
            # the checkpoint must start at exactly its lsn + 1; a gap
            # means the suffix was pruned against a newer checkpoint
            # that is now unusable
            L = int(ck["meta"].get("wal_lsn", 0))
            after = [int(r.get("lsn", 0)) for r in records
                     if int(r.get("lsn", 0)) > L]
            if after and min(after) != L + 1:
                stale = True
        if ck is None or stale:
            # torn / corrupt, or claiming an lsn this log never wrote:
            # quarantined, counted; fall back to the next older one
            report["ckpt_quarantined"] += 1
            _obs.serving_integrity("wal_ckpt", "quarantined")
            if repair:
                try:
                    os.replace(os.path.join(path, fn),
                               os.path.join(path, fn + ".quarantined"))
                except OSError:
                    pass
            continue
        meta = ck["meta"]
        ckpt_lsn = int(meta.get("wal_lsn", 0))
        state["next_rid"] = int(meta.get("next_rid", 0))
        state["geometry"] = _geometry(meta)
        gs = ck["arrays"].get(GEN_STATE)
        if gs is not None and gs.size:
            state["gen_state"] = gs
        state["grammars"].update(meta.get("grammars") or {})
        pf = meta.get("prefix")
        if pf:
            # checkpoint_prefix=True carried the trie's structure and
            # its pages' KV bytes (raw uint8, the drain convention)
            state["prefix"] = {
                "page_ids": pf["page_ids"],
                "records": pf["records"],
                "arrays": {
                    n: np.frombuffer(
                        bytes(ck["arrays"][f"prefix_{n}"]),
                        _np_dtype(pf["dtypes"][n])
                    ).reshape(pf["shapes"][n])
                    for n in pf["shapes"]}}
        for rec in meta.get("sessions", ()):
            state["sessions"][int(rec["rid"])] = dict(rec)
        break
    replayed = 0
    for rec in records:
        if int(rec.get("lsn", 0)) <= ckpt_lsn:
            continue
        replayed += 1
        kind = rec.get("kind")
        if kind == "meta":
            state["geometry"] = _geometry(rec)
            state["next_rid"] = max(state["next_rid"],
                                    int(rec.get("next_rid", 0)))
        elif kind == "submit":
            rid = int(rec["rid"])
            state["sessions"][rid] = {
                k: rec.get(k) for k in
                ("rid", "prompt", "max_new_tokens", "eos_token_id",
                 "priority", "deadline_remaining_s", "tokens",
                 "admitted", "preemptions", "swapped", "adapter_id",
                 "constraint")}
            state["next_rid"] = max(state["next_rid"], rid + 1)
        elif kind == "step":
            _apply_delta(state["sessions"], rec)
        elif kind == "steps":
            # one batched frame a journal sync: entries apply in order
            for d in rec.get("entries", ()):
                _apply_delta(state["sessions"], d)
        elif kind == "grammar":
            # a shared DFA table, appended once per hash
            state["grammars"][rec["hash"]] = rec["dfa"]
        elif kind in ("finish", "forget"):
            state["sessions"].pop(int(rec["rid"]), None)
        elif kind == GEN_STATE:
            state["gen_state"] = np.frombuffer(
                base64.b64decode(rec["data"]),
                _np_dtype(rec["dtype"])).reshape(rec["shape"])
    report["replayed_records"] = replayed
    report["ckpt_lsn"] = ckpt_lsn
    state["report"] = report
    return state
