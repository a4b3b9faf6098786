"""Append-only sweep journal: checkpoint/resume for chunked sweeps (port
of ``pycatkin_tpu/robustness/journal.py``).

After each chunk the runner appends one manifest record (chunk id, lane
range, status, per-lane failure count, degradation events) to
``journal.jsonl`` and writes the chunk's result arrays to an ``.npz``
next to it (utils/io). A resumed run replays the manifest, verifies the
conditions fingerprint, loads the completed chunks' arrays bit for bit
and re-dispatches only missing or failed chunks.

Crash safety: manifest lines are flushed and fsynced per record and a
truncated final line (kill mid-write) is ignored on replay; chunk
``.npz`` files are written to a temp name and atomically renamed, so a
manifest record never points at a partial file.

Manifest schema (one JSON object per line)::

  {"kind": "header", "fingerprint": ..., "n_lanes": ..., "chunk": ...,
   "version": 1, "manifest": {...}}
  {"kind": "chunk", "chunk_id": ..., "start": ..., "stop": ...,
   "status": "done"|"salvaged"|"quarantined", "npz": "chunk_00003.npz",
   "n_failed": ..., "events": [...]}

Later records for the same chunk_id supersede earlier ones, so a resumed
run overwrites a previously salvaged chunk with a clean re-solve by
appending.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

from ..utils.io import (append_json_line, atomic_save_results,
                        load_results, read_json_lines)

MANIFEST = "journal.jsonl"
_VERSION = 1

# Statuses that carry a usable result payload; "salvaged" and
# "quarantined" chunks are deliberately NOT reused on resume -- a
# restart is the chance to re-solve what degraded.
_COMPLETE = ("done",)


class JournalMismatchError(RuntimeError):
    """Resume attempted against a journal written for different
    conditions/options (fingerprint mismatch)."""


def conditions_fingerprint(conds, extra=None) -> str:
    """Order-stable content hash of a Conditions (dtype, shape and bytes
    of every field, in field order) plus any extra context (solver
    options, chunk size, ...) -- the resume guard that a journal is only
    ever replayed against the sweep that wrote it. Tensors are read on
    the host; the string equals the JAX package's for the same numpy
    conditions and ``extra``."""
    h = hashlib.sha256()
    for leaf in conds:
        if hasattr(leaf, "detach"):
            leaf = leaf.detach().cpu().numpy()
        a = np.ascontiguousarray(np.asarray(leaf))
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    if extra is not None:
        h.update(repr(extra).encode())
    return h.hexdigest()[:32]


class SweepJournal:
    """One sweep's on-disk journal (a directory).

    Opening modes:
    - fresh (``resume=False``): the directory must not already hold a
      manifest (refuses to silently mix two sweeps' records).
    - resume (``resume=True``): replays an existing manifest; when
      ``fingerprint`` is given it must match the header.
    ``device``: the device the run is for, recorded in the header's run
    manifest (None: the CUDA card). ``fsync``: also fsync each chunk's
    payload and its directory (the JAX package's
    ``PYCATKIN_JOURNAL_FSYNC``); manifest lines are always fsynced.
    """

    def __init__(self, path: str, fingerprint: str | None = None,
                 n_lanes: int | None = None, chunk: int | None = None,
                 resume: bool = False, device=None, fsync: bool = False):
        self.path = str(path)
        self.fsync = bool(fsync)
        os.makedirs(self.path, exist_ok=True)
        self.manifest_path = os.path.join(self.path, MANIFEST)
        self._records = []
        if os.path.exists(self.manifest_path):
            if not resume:
                raise RuntimeError(
                    f"journal already exists at {self.manifest_path}; "
                    "pass resume=True to continue it (or use a fresh "
                    "directory)")
            self._records = read_json_lines(self.manifest_path,
                                            tolerate_torn_tail=True)
        header = next((r for r in self._records
                       if r.get("kind") == "header"), None)
        if header is None:
            from ..obs.manifest import run_manifest
            # The run manifest makes a journal self-describing (what
            # code/backend wrote it). Resume ignores unknown header
            # keys.
            header = {"kind": "header", "version": _VERSION,
                      "fingerprint": fingerprint, "n_lanes": n_lanes,
                      "chunk": chunk, "manifest": run_manifest(
                          device=device)}
            append_json_line(self.manifest_path, header)
            self._records.append(header)
        elif fingerprint is not None and \
                header.get("fingerprint") not in (None, fingerprint):
            raise JournalMismatchError(
                f"journal at {self.path} was written for fingerprint "
                f"{header.get('fingerprint')!r}, not {fingerprint!r}: "
                "the conditions/options differ from the original sweep")
        self.header = header

    # -----------------------------------------------------------------
    def completed(self) -> dict:
        """{chunk_id: latest manifest record} for chunks whose latest
        record carries a loadable result ('done')."""
        latest: dict[int, dict] = {}
        for rec in self._records:
            if rec.get("kind") == "chunk":
                latest[int(rec["chunk_id"])] = rec
        return {cid: rec for cid, rec in latest.items()
                if rec.get("status") in _COMPLETE
                and os.path.exists(os.path.join(self.path, rec["npz"]))}

    def chunk_records(self) -> list[dict]:
        return [r for r in self._records if r.get("kind") == "chunk"]

    def load_chunk(self, rec: dict) -> dict:
        """Result arrays of a completed chunk record, bit-identical to
        what the original run computed (lossless .npz round trip)."""
        return load_results(os.path.join(self.path, rec["npz"]))

    def record_chunk(self, chunk_id: int, start: int, stop: int,
                     status: str, arrays: dict | None = None,
                     events=(), n_failed: int = 0) -> dict:
        """Durably record one finished (or salvaged) chunk: arrays to
        an atomically-renamed .npz, then the manifest line."""
        rec = {"kind": "chunk", "chunk_id": int(chunk_id),
               "start": int(start), "stop": int(stop),
               "status": str(status), "n_failed": int(n_failed),
               "events": list(events)}
        if arrays is not None:
            fname = f"chunk_{chunk_id:05d}.npz"
            # Write-then-rename so this manifest line can never point
            # at a torn payload, even for a process killed mid-write.
            atomic_save_results(os.path.join(self.path, fname), arrays,
                                fsync=self.fsync)
            rec["npz"] = fname
        append_json_line(self.manifest_path, rec)
        self._records.append(rec)
        return rec
