"""Write-ahead request journal of the front router (port of
``pycatkin_tpu/serve/durable.py``).

The router's in-memory in-flight table is a single failure domain: a
router crash forfeits every accepted-but-unanswered request. This module
lifts the chunk journal's discipline (:mod:`..robustness.journal`) into
serving: an ``accepted`` record is fsynced (:func:`..utils.io.
append_json_line`) before the ack reaches the client's socket, an
``answered`` record carries the full response plus its canonical form
(:func:`.protocol.canonical_answer`, the string the duplicate audit
compares), and replay tolerates a torn final line
(``read_json_lines(tolerate_torn_tail=True)``): a kill mid-append can
tear at most the one record that was never acknowledged.

A journal is a directory of size-bounded segments
(``requests_00000.jsonl``, ``requests_00001.jsonl``, ...). Appends go to
the highest-numbered (active) segment; once it reaches
``segment_bytes`` the next append rotates to a fresh segment, and any
sealed segment whose every ``accepted`` key has an ``answered`` record
is deleted (compaction). A segment holding an unanswered key is never
deleted, so compaction loses no accepted work; it does bound the
duplicate-serving window: once a fully answered segment is compacted, a
duplicate of one of its keys arriving after the next router boot is
served as a fresh request (safe: same-width sweeps are bitwise
deterministic, packed or solo).

The records are the JAX package's field for field (``json.dumps`` with
sorted keys, one line each), so either package replays the other's
journal.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

from ..obs import metrics as _metrics
from ..utils.io import append_json_line, read_json_lines
from ..utils.profiling import record_event
from .protocol import DEFAULT_SEGMENT_BYTES, canonical_answer

_SEGMENT_PREFIX = "requests_"
_SEGMENT_SUFFIX = ".jsonl"


def _segment_name(seq: int) -> str:
    return f"{_SEGMENT_PREFIX}{seq:05d}{_SEGMENT_SUFFIX}"


class RequestJournal:
    """Crash-durable accepted / answered ledger for keyed sweep requests.

    Every method is thread-safe and synchronous (they fsync); the router
    calls them through ``asyncio.to_thread`` so the event loop never
    blocks on disk. Constructing the journal replays every segment on
    disk, so ``unanswered()`` / ``answered_response()`` are
    authoritative at once after a crash. ``segment_bytes`` None is
    :data:`.protocol.DEFAULT_SEGMENT_BYTES` (1 MiB).
    """

    def __init__(self, path: str, segment_bytes: Optional[int] = None):
        self.path = str(path)
        os.makedirs(self.path, exist_ok=True)
        if segment_bytes is None:
            segment_bytes = DEFAULT_SEGMENT_BYTES
        self.segment_bytes = max(1, int(segment_bytes))
        self._lock = threading.Lock()
        # Every field below is guarded by self._lock.
        self._accepted = {}       # key -> wire payload, unanswered only
        self._answers = {}        # key -> stored response (id stripped)
        self._segment_keys = {}   # seq -> accepted keys in that segment
        self._active_seq = 0
        self._appends = 0
        self._rotations = 0
        self._compacted = 0
        self._replayed_records = 0
        self._replay()

    # -- replay ---------------------------------------------------------

    def _segment_path(self, seq: int) -> str:
        return os.path.join(self.path, _segment_name(seq))

    def _segments_on_disk(self) -> list:
        seqs = []
        for name in os.listdir(self.path):
            if (name.startswith(_SEGMENT_PREFIX)
                    and name.endswith(_SEGMENT_SUFFIX)):
                stem = name[len(_SEGMENT_PREFIX):-len(_SEGMENT_SUFFIX)]
                try:
                    seqs.append(int(stem))
                except ValueError:
                    continue
        return sorted(seqs)

    def _replay(self) -> None:
        with self._lock:
            seqs = self._segments_on_disk()
            for seq in seqs:
                records = read_json_lines(self._segment_path(seq),
                                          tolerate_torn_tail=True)
                keys = set()
                for rec in records:
                    kind = rec.get("kind")
                    key = rec.get("key")
                    if key is None:
                        continue
                    if kind == "accepted":
                        keys.add(key)
                        if (key not in self._answers
                                and key not in self._accepted):
                            self._accepted[key] = rec.get("payload")
                    elif kind == "answered":
                        self._answers[key] = rec.get("response")
                        self._accepted.pop(key, None)
                    self._replayed_records += 1
                self._segment_keys[seq] = keys
            self._active_seq = seqs[-1] if seqs else 0
        record_event("durable", action="replay", path=self.path,
                     segments=len(seqs),
                     records=self._replayed_records,
                     pending=len(self._accepted),
                     answered=len(self._answers))

    # -- writes ---------------------------------------------------------

    def record_accepted(self, key: str, payload: dict) -> bool:
        """Fsync an ``accepted`` record for ``key``. Idempotent: a key
        already journaled (accepted or answered) writes nothing and
        returns False. The caller must not ack the client before this
        returns: the fsync-before-ack order is the durability
        contract."""
        key = str(key)
        with self._lock:
            if key in self._accepted or key in self._answers:
                return False
            self._maybe_rotate_locked()
            append_json_line(self._segment_path(self._active_seq),
                             {"kind": "accepted", "key": key,
                              "payload": payload})
            self._accepted[key] = payload
            self._segment_keys.setdefault(self._active_seq,
                                          set()).add(key)
            self._appends += 1
        _metrics.counter("pycatkin_durable_accepted_total",
                         "keyed requests journaled as accepted").inc()
        return True

    def record_answered(self, key: str, response: dict):
        """Fsync an ``answered`` record carrying the response and its
        canonical form. Returns the prior stored response when the key
        was already answered (replay racing a client resubmission), so
        the caller can audit bitwise identity; returns None when this
        call stored the answer."""
        key = str(key)
        stored = {k: v for k, v in response.items() if k != "id"}
        with self._lock:
            prior = self._answers.get(key)
            if prior is not None:
                return prior
            self._maybe_rotate_locked()
            append_json_line(self._segment_path(self._active_seq),
                             {"kind": "answered", "key": key,
                              "response": stored,
                              "canonical": canonical_answer(response)})
            self._answers[key] = stored
            self._accepted.pop(key, None)
            self._appends += 1
            self._compact_locked()
        _metrics.counter("pycatkin_durable_answered_total",
                         "keyed requests journaled as answered").inc()
        return None

    def _maybe_rotate_locked(self) -> None:
        try:
            size = os.path.getsize(self._segment_path(self._active_seq))
        except OSError:
            size = 0
        if size >= self.segment_bytes:
            self._active_seq += 1
            self._rotations += 1
            record_event("durable", action="rotate",
                         seq=self._active_seq)

    def _compact_locked(self) -> None:
        # A sealed segment is deletable once every key accepted in it is
        # answered (one with no accepted keys, answers only, is
        # vacuously done). Unanswered work pins its segment.
        for seq in sorted(self._segment_keys):
            if seq == self._active_seq:
                continue
            keys = self._segment_keys[seq]
            if any(k not in self._answers for k in keys):
                continue
            try:
                os.unlink(self._segment_path(seq))
            except OSError:
                continue
            del self._segment_keys[seq]
            self._compacted += 1
            record_event("durable", action="compact", seq=seq,
                         keys=len(keys))
            _metrics.counter(
                "pycatkin_durable_compacted_segments_total",
                "fully-answered journal segments deleted").inc()

    # -- reads ----------------------------------------------------------

    def answered_response(self, key: str):
        """The journaled answer for ``key`` (without an ``id``; the
        caller stamps the duplicate request's own id) or None."""
        with self._lock:
            stored = self._answers.get(str(key))
            return dict(stored) if stored is not None else None

    def is_accepted(self, key: str) -> bool:
        with self._lock:
            k = str(key)
            return k in self._accepted or k in self._answers

    def unanswered(self) -> list:
        """``(key, payload)`` pairs accepted but never answered, in
        acceptance order: the boot-time replay's work list."""
        with self._lock:
            return [(k, dict(p) if isinstance(p, dict) else p)
                    for k, p in self._accepted.items()]

    def stats(self) -> dict:
        with self._lock:
            return {"path": self.path,
                    "segments": max(1, len(self._segment_keys)),
                    "active_segment": self._active_seq,
                    "segment_bytes": self.segment_bytes,
                    "pending": len(self._accepted),
                    "answered": len(self._answers),
                    "appends": self._appends,
                    "rotations": self._rotations,
                    "compacted_segments": self._compacted,
                    "replayed_records": self._replayed_records}
