"""Wire schema and settings of the serving layer (port of
``pycatkin_tpu/serve/protocol.py``; protocol ``pycatkin-serve/v1``).

One JSON object per line, both directions. Requests carry ``op``
(``"sweep"`` | ``"transient"`` | ``"ping"`` | ``"stats"`` | ``"drain"``
| ``"result"``) and, for sweeps, a mechanism in the reference input-file schema
(:func:`..utils.io.system_to_dict`), a conditions grid and a deadline
class; transients add a save grid. Responses echo the request ``id`` and
either ``ok: true`` with the result payload or ``ok: false`` with a
structured error -- admission control rejects are data, not dropped
connections.

Durable extension: a sweep may carry an optional client-chosen
``idempotency_key``. Against a journal-backed router
(:mod:`.router`, :mod:`.durable`) the client then receives an
out-of-band ``{"accepted": true, "key": ...}`` ack line once the request
is fsynced to the write-ahead journal, and a ``result`` op
(``{"op": "result", "key": ...}``) fetches the journaled answer for a
key. Keyless requests are byte-identical to the pre-durability protocol.

The port reads no environment variable: :class:`ServeConfig`'s None
fields take the JAX package's defaults (host ``127.0.0.1``, port 0,
``max_pending`` 256, runner ``inproc`` (``"elastic"`` runs solo
groups through the elastic scheduler's workers), wait budgets 0.02 / 0.2 / 2.0 s
by deadline class), and ``device`` picks the card (None) or the CPU
(``"cpu"``). The per-class request timeouts are a mapping that the front
router (``RouterConfig.timeouts``) and the TCP client (``timeouts=``)
take, and the journal's segment size and replay concurrency are
``RouterConfig`` fields; ``python -m pycatkin_tpu_torch.serve`` has a
flag for each.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

PROTOCOL = "pycatkin-serve/v1"

#: The longest JSON line the server and the TCP client read (asyncio's
#: stream default is 64 KiB): a 65,536-lane request is ~1.3 MB and its
#: answer ~10 MB.
LINE_LIMIT = 1 << 28

_DEFAULT_BUDGETS = {"interactive": 0.02, "standard": 0.2, "batch": 2.0}
DEADLINE_CLASSES = tuple(_DEFAULT_BUDGETS)

# Per-class end-to-end request deadlines (seconds from send to
# response), distinct from the coalescing wait budgets above: the wait
# budget bounds how long a request may sit collecting co-tenants; the
# request timeout bounds the whole round trip, solve included, and is
# what the TCP client and the front router resolve to a structured
# ``E_TIMEOUT`` instead of hanging on a stalled peer.
_DEFAULT_TIMEOUTS = {"interactive": 30.0, "standard": 120.0,
                     "batch": 600.0}

# The write-ahead request journal (:mod:`.durable`): the size past which
# a segment rotates, and how many journaled requests the router's boot
# replay re-dispatches at once.
DEFAULT_SEGMENT_BYTES = 1 << 20
DEFAULT_REPLAY_CONCURRENCY = 4

# Structured reject/error codes.
E_BAD_REQUEST = "bad_request"
E_OVERLOADED = "overloaded"
E_DRAINING = "draining"
E_INTERNAL = "internal"
E_TIMEOUT = "timeout"
# The transport under an in-flight request died (TCP client): the
# error names the peer and whether the request carried an idempotency
# key, so callers know a resubmit is safe.
E_CONN_LOST = "conn_lost"
# A ``result`` fetch named a key the journal has no answer for.
E_UNKNOWN_KEY = "unknown_key"


class ServeError(Exception):
    """A request failure that maps to a structured error response."""

    def __init__(self, code: str, message: str):
        self.code = code
        super().__init__(message)


def deadline_budgets() -> dict:
    """Per-class coalescing wait budgets (seconds a request may sit
    waiting for co-tenants)."""
    return dict(_DEFAULT_BUDGETS)


@dataclass
class ServeConfig:
    """Everything a :class:`..serve.server.SweepServer` needs to boot.
    ``None`` fields take the defaults at construction; ``device`` None
    is the CUDA card."""

    host: Optional[str] = None
    port: Optional[int] = None
    max_pending: Optional[int] = None
    runner: Optional[str] = None          # "inproc" | "elastic"
    aot_pack: Optional[str] = None        # not ported: must stay None
    work_dir: Optional[str] = None        # coalescer events file
    max_occupancy: Optional[int] = None   # coalescer knob passthrough
    max_wait_s: Optional[float] = None
    tick_s: float = 0.005                 # scheduler poll period
    n_workers: int = 2                    # the elastic runner's width
    budgets: dict = field(default_factory=deadline_budgets)
    device: Optional[str] = None          # None: the CUDA card

    def __post_init__(self):
        if self.host is None:
            self.host = "127.0.0.1"
        if self.port is None:
            self.port = 0
        if self.max_pending is None:
            self.max_pending = 256
        if self.runner is None:
            self.runner = "inproc"
        if self.runner not in ("inproc", "elastic"):
            raise ValueError(f"runner must be 'inproc' or 'elastic', "
                             f"got {self.runner!r}")
        if self.aot_pack:
            raise ValueError("aot_pack: the port compiles no programs, "
                             "and AOT cache packs are not ported "
                             "(ROADMAP.md Queue A)")
        if self.max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, "
                             f"got {self.max_pending}")

    def wait_budget_for(self, deadline_class: str) -> float:
        try:
            return float(self.budgets[deadline_class])
        except KeyError:
            raise ServeError(
                E_BAD_REQUEST,
                f"unknown deadline_class {deadline_class!r}; choose "
                f"one of {sorted(self.budgets)}") from None


def request_timeouts(overrides=None) -> dict:
    """Per-class end-to-end request deadlines in seconds: the defaults,
    updated by the ``overrides`` mapping (class -> seconds), if any."""
    out = dict(_DEFAULT_TIMEOUTS)
    for cls, sec in (overrides or {}).items():
        if cls not in out:
            raise ValueError(f"unknown deadline class {cls!r}; choose "
                             f"one of {sorted(out)}")
        out[cls] = float(sec)
    return out


def request_timeout_for(deadline_class: str, timeouts=None) -> float:
    """The end-to-end deadline of one request of this class under the
    ``timeouts`` overrides (see :func:`request_timeouts`); unknown
    classes get the ``standard`` deadline (the request itself is
    validated -- and rejected -- elsewhere)."""
    table = request_timeouts(timeouts)
    return table.get(str(deadline_class), table["standard"])


def jsonable(obj):
    """Recursively convert a result payload (numpy arrays/scalars,
    nested dicts/sequences) into plain JSON types."""
    if isinstance(obj, dict):
        return {str(k): jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [jsonable(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return jsonable(obj.tolist())
    if isinstance(obj, (np.bool_,)):
        return bool(obj)
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        v = float(obj)
        return v if np.isfinite(v) else repr(v)
    if isinstance(obj, float) and not np.isfinite(obj):
        return repr(obj)
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if hasattr(obj, "detach") and hasattr(obj, "cpu"):
        # A tensor: one transfer to host numpy (the server's flushes
        # arrive here already on the host, from their counted sync).
        return jsonable(obj.detach().cpu().numpy())
    if hasattr(obj, "__array__"):
        return jsonable(np.asarray(obj))
    return repr(obj)


def error_response(req_id, code: str, message: str, **extra) -> dict:
    """Structured error line. ``extra`` keys (e.g. ``peer``,
    ``idempotency_key`` on ``conn_lost``) ride inside the ``error``
    object; legacy callers pass none and the shape is unchanged."""
    err = {"code": code, "message": message}
    if extra:
        err.update(extra)
    return {"protocol": PROTOCOL, "id": req_id, "ok": False,
            "error": err}


def accepted_ack(req_id, key: str) -> dict:
    """The durability ack: written to the socket only after the
    ``accepted`` journal record is fsynced, it promises the keyed
    request will be answered exactly once even across router death."""
    return {"protocol": PROTOCOL, "id": req_id, "accepted": True,
            "key": key}


def canonical_answer(resp: dict) -> str:
    """Canonical form of a sweep answer for bitwise-identity audits: a
    served answer against the same request's solo run, the router's
    duplicate-suppression audit (hedge losers, failover stragglers), the
    journaled-answer replay audit and the chaos drill all compare this
    string. The solver-derived payload only; envelope fields (``id``,
    ``timing``, ``pack``) legitimately differ between duplicates and
    are excluded."""
    return json.dumps({"result": resp.get("result"),
                       "quarantine": resp.get("quarantine"),
                       "lanes": resp.get("lanes")}, sort_keys=True)


def parse_sweep_request(payload: dict) -> dict:
    """Validate the sweep-specific fields of a request payload; returns
    ``{mechanism, T(list), p(list), tof_terms, deadline_class,
    wait_budget_s, want}``. Raises :class:`ServeError` (bad_request)
    with the offending field named."""
    mech = payload.get("mechanism")
    if mech is None:
        raise ServeError(E_BAD_REQUEST, "/mechanism: missing (expected "
                         "reference input-file JSON or a built System)")
    conds = payload.get("conditions")
    if not isinstance(conds, dict):
        raise ServeError(E_BAD_REQUEST,
                         "/conditions: expected an object like "
                         '{"T": [500, 550], "p": 1e5}')
    T = conds.get("T")
    if T is None:
        raise ServeError(E_BAD_REQUEST, "/conditions/T: missing")
    T = [float(t) for t in (T if isinstance(T, (list, tuple)) else [T])]
    if not T:
        raise ServeError(E_BAD_REQUEST, "/conditions/T: empty grid")
    p = conds.get("p", 1.0e5)
    p = [float(v) for v in (p if isinstance(p, (list, tuple))
                            else [p] * len(T))]
    if len(p) != len(T):
        raise ServeError(E_BAD_REQUEST,
                         f"/conditions/p: {len(p)} values for "
                         f"{len(T)} temperatures")
    tof_terms = payload.get("tof_terms")
    if tof_terms is not None and not isinstance(tof_terms, (list, tuple)):
        raise ServeError(E_BAD_REQUEST, "/tof_terms: expected a list")
    cls = payload.get("deadline_class", "standard")
    wait = payload.get("wait_budget_s")
    if wait is not None:
        wait = float(wait)
        if wait < 0:
            raise ServeError(E_BAD_REQUEST,
                             "/wait_budget_s: must be >= 0")
    want = payload.get("return", ())
    if not isinstance(want, (list, tuple)):
        raise ServeError(E_BAD_REQUEST, "/return: expected a list of "
                         "result keys (e.g. [\"y\"])")
    key = payload.get("idempotency_key")
    if key is not None:
        if not isinstance(key, str) or not key:
            raise ServeError(E_BAD_REQUEST, "/idempotency_key: "
                             "expected a non-empty string")
        if len(key) > 256:
            raise ServeError(E_BAD_REQUEST, "/idempotency_key: "
                             "longer than 256 characters")
    return {"mechanism": mech, "T": T, "p": p,
            "tof_terms": list(tof_terms) if tof_terms else None,
            "deadline_class": str(cls), "wait_budget_s": wait,
            "want": [str(k) for k in want], "idempotency_key": key}


def parse_transient_request(payload: dict) -> dict:
    """Validate the transient-specific fields of a request payload
    (op ``transient``): the sweep fields minus
    ``tof_terms``, plus the required dense-output ``save_ts`` grid --
    at least two non-negative, strictly increasing save times starting
    at 0. Returns ``{mechanism, T(list), p(list), save_ts(list),
    deadline_class, wait_budget_s, want, idempotency_key}``; raises
    :class:`ServeError` (bad_request) with the offending field
    named."""
    parsed = parse_sweep_request({**payload, "tof_terms": None})
    ts = payload.get("save_ts")
    if not isinstance(ts, (list, tuple)) or len(ts) < 2:
        raise ServeError(E_BAD_REQUEST, "/save_ts: expected a list of "
                         "at least 2 save times")
    try:
        ts = [float(t) for t in ts]
    except (TypeError, ValueError):
        raise ServeError(E_BAD_REQUEST,
                         "/save_ts: non-numeric entry") from None
    if ts[0] != 0.0:
        raise ServeError(E_BAD_REQUEST, "/save_ts: must start at 0 "
                         "(the reported trajectory includes y0)")
    if any(b <= a for a, b in zip(ts, ts[1:])):
        raise ServeError(E_BAD_REQUEST,
                         "/save_ts: must be strictly increasing")
    if not all(np.isfinite(ts)):
        raise ServeError(E_BAD_REQUEST, "/save_ts: non-finite entry")
    parsed.pop("tof_terms", None)
    parsed["save_ts"] = ts
    return parsed
