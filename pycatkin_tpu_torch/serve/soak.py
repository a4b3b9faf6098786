"""Soak harness: stream randomized synthetic mechanisms through a live
:class:`.server.SweepServer` and report serving metrics in a BENCH-style
JSON record (port of the single-server soak of
``pycatkin_tpu/serve/soak.py``).

Phases:

1. **pool** -- seed-deterministic mechanisms per requested ABI bucket
   (:func:`..models.synthetic.synthetic_system_for_bucket`), so the soak
   controls pack occupancy bucket by bucket;
2. **warm** -- the server's warm-up (kernels, solo and packed runs per
   k_bucket), then one streamed burst per bucket through the real
   serving path; everything after :meth:`SweepServer.mark_warm` counts
   against the zero-compile gate;
3. **measure** -- ``n_requests`` concurrent sweeps, round-robin over
   buckets, random mechanism + temperature grid per request; client-side
   latency per request, response-schema presence audited;
4. **drain burst** -- a final burst is submitted and the server is
   drained while they are pending: graceful drain must complete every
   accepted request (no-loss proof).

The record carries ``serve.p50_s`` / ``serve.p99_s`` /
``serve.zero_compile_rate`` / ``serve.mean_occupancy``;
:func:`check_soak_record` gates it.

The fleet tier has two drills of its own: :func:`run_chaos_drill`
(replicas on the card behind the front router, replicas and router
killed mid-stream, every answer bitwise an undisturbed in-process
server's; :func:`check_chaos_record` gates it) and
:func:`run_durable_smoke` (the request journal's round trip and a
router-kill replay over a stub replica, seconds on the CPU;
:func:`check_durable_record`). ``python -m pycatkin_tpu_torch.serve.soak
--chaos`` / ``--durable`` run them.
"""

from __future__ import annotations

import asyncio
import json
import os
import sys
import time
from typing import Optional

import numpy as np

SCHEMA = "pycatkin-serve-soak/v1"

# Response fields every ok sweep response must carry (acceptance:
# manifest, telemetry and quarantine round-trip on EVERY response).
REQUIRED_RESPONSE_FIELDS = ("result", "manifest", "lane_telemetry",
                            "quarantine", "pack", "timing")

# Largest ABI bucket the soak mixes `transient` requests into: a
# transient's time is its slowest lane's step count, which at the big
# buckets would serialize every co-resident sweep flush behind it.
TRANSIENT_MIX_MAX_BUCKET = 32


def _audit_response(resp: dict) -> list:
    """Names of required fields missing from an ok response.
    ``lane_telemetry`` must be present but may be null (a runner that
    produced none); everything else must be a real value."""
    bad = [f for f in REQUIRED_RESPONSE_FIELDS
           if f not in resp
           or (resp[f] is None and f != "lane_telemetry")]
    # Verdict arrays must arrive as real JSON lists, one entry per
    # lane -- a serializer regression that ships reprs instead of
    # values (e.g. an unhandled array type) is a schema violation,
    # not a cosmetic one.
    result = resp.get("result")
    if isinstance(result, dict):
        # Transient responses carry ``save_points`` and a per-lane
        # ``ok`` verdict; sweeps carry per-lane ``success``.
        key = "ok" if "save_points" in resp else "success"
        succ = result.get(key)
        if not (isinstance(succ, list)
                and len(succ) == resp.get("lanes")):
            bad.append(f"result.{key}")
    return bad


def _percentile(values, q) -> Optional[float]:
    if not values:
        return None
    return float(np.percentile(np.asarray(values, dtype=float), q))


async def soak_async(n_requests: int = 1000, buckets=(16, 32, 128),
                     lanes: int = 4, seed: int = 0,
                     transport: str = "inproc",
                     mechs_per_bucket: int = 6,
                     max_occupancy: int = 8,
                     concurrency: int = 16,
                     deadline_class: str = "standard",
                     t_range=(480.0, 520.0),
                     drain_burst: Optional[int] = None,
                     transient_frac: float = 0.0,
                     verbose: bool = False, device=None,
                     on_response=None) -> dict:
    """Run the full soak against a fresh server on ``device`` (None: the
    CUDA card; ``"cpu"``); returns the BENCH record. ``transport`` is
    ``"inproc"`` (direct handler calls, mechanisms passed as built
    Systems) or ``"tcp"`` (full JSON wire round trip on localhost).
    ``transient_frac`` > 0 mixes that fraction of ``transient`` requests
    into the measured stream on a fixed log-spaced save grid, on buckets
    <= :data:`TRANSIENT_MIX_MAX_BUCKET` only. ``on_response(i, sim,
    T, save_ts, resp)``, if given, is called for every measured request
    ``i`` (``save_ts`` None for a sweep) -- a hook to audit answers."""
    from ..models.synthetic import synthetic_system_for_bucket
    from .client import SweepClient, TcpSweepClient
    from .protocol import ServeConfig
    from .server import SweepServer

    rng = np.random.default_rng(seed)
    t_wall0 = time.monotonic()

    def say(msg):
        if verbose:
            print(f"soak: {msg}", flush=True)

    # -- phase 1: mechanism pool --------------------------------------
    say(f"building pool: {mechs_per_bucket} mechanisms x "
        f"{len(buckets)} buckets")
    pool = {b: [synthetic_system_for_bucket(
                    b, seed=int(rng.integers(0, 2**31)), device=device)
                for _ in range(mechs_per_bucket)]
            for b in buckets}

    cfg = ServeConfig(port=0, max_occupancy=max_occupancy, device=device)
    server = await SweepServer(cfg).start(listen=(transport == "tcp"))
    tcp = None
    if transport == "tcp":
        tcp = await TcpSweepClient("127.0.0.1", server.port).connect()
        client = tcp
    elif transport == "inproc":
        client = SweepClient(server)
    else:
        raise ValueError(f"transport must be 'inproc' or 'tcp', "
                         f"got {transport!r}")

    def payload_mech(sim):
        # TCP exercises the full wire schema; in-proc skips the JSON
        # round-trip (the production embedding's fast path).
        if transport == "tcp":
            from ..utils.io import system_to_dict
            return system_to_dict(sim)
        return sim

    def random_T():
        return [float(t) for t in rng.uniform(*t_range, size=lanes)]

    # One fixed save grid for the whole soak: every transient request
    # shares it, so same-bucket transients coalesce into packed
    # flushes just like sweeps. Only the small buckets mix transients
    # (see the docstring); with no eligible bucket the mix degrades to
    # a pure sweep soak.
    save_ts = [0.0] + [float(t) for t in np.logspace(-9, 0, 13)]
    transient_buckets = [b for b in buckets
                         if b <= TRANSIENT_MIX_MAX_BUCKET]
    if transient_frac > 0 and not transient_buckets:
        transient_frac = 0.0

    async def one_request(sim, sem, latencies, failures, violations,
                          transient=False, index=None):
        async with sem:
            t0 = time.monotonic()
            T = random_T()
            if transient:
                resp = await client.transient(
                    payload_mech(sim), T, save_ts,
                    deadline_class=deadline_class)
            else:
                resp = await client.sweep(
                    payload_mech(sim), T,
                    deadline_class=deadline_class)
            dt = time.monotonic() - t0
            if resp.get("ok"):
                latencies.append(dt)
                missing = _audit_response(resp)
                if missing:
                    violations.append({"id": resp.get("id"),
                                       "missing": missing})
            else:
                failures.append(resp.get("error", {}))
            if on_response is not None and index is not None:
                on_response(index, sim, T,
                            save_ts if transient else None, resp)

    try:
        # -- phase 2: warm --------------------------------------------
        say("warming (kernels, solo and packed runs)")
        k_buckets = sorted({1 << i for i in range(
            max(1, max_occupancy).bit_length())} | {max_occupancy})
        prewarm = await asyncio.to_thread(
            server.warm, [pool[b][0] for b in buckets], lanes,
            tuple(k for k in k_buckets if k > 1))
        if transient_frac > 0:
            # Transient programs only for the buckets that mix them.
            tw = await asyncio.to_thread(
                server.warm, [pool[b][0] for b in transient_buckets],
                lanes, tuple(k for k in k_buckets if k > 1), save_ts)
            prewarm = {k: prewarm[k] + tw[k] for k in prewarm}
        say(f"prewarm: {prewarm}")
        warm_lat, warm_fail, warm_viol = [], [], []
        sem = asyncio.Semaphore(concurrency)
        warm_jobs = []
        for b in buckets:
            # One full burst (packs) plus one straggler (K=1 flush)
            # per bucket, through the real serving path.
            for i in range(max_occupancy):
                warm_jobs.append(one_request(
                    pool[b][i % len(pool[b])], sem, warm_lat,
                    warm_fail, warm_viol))
            if transient_frac > 0 and b in transient_buckets:
                for i in range(max_occupancy):
                    warm_jobs.append(one_request(
                        pool[b][i % len(pool[b])], sem, warm_lat,
                        warm_fail, warm_viol, transient=True))
        await asyncio.gather(*warm_jobs)
        for b in buckets:
            await one_request(pool[b][0], sem, warm_lat, warm_fail,
                              warm_viol)
            if transient_frac > 0 and b in transient_buckets:
                await one_request(pool[b][0], sem, warm_lat,
                                  warm_fail, warm_viol,
                                  transient=True)
        server.mark_warm()
        n_warmup = len(warm_lat) + len(warm_fail)
        say(f"warmup done: {n_warmup} requests "
            f"({len(warm_fail)} failed)")

        # -- phase 3: measured stream ---------------------------------
        latencies, failures, violations = [], [], []
        jobs = []
        n_transient = 0
        for i in range(n_requests):
            b = buckets[i % len(buckets)]
            sim = pool[b][int(rng.integers(0, len(pool[b])))]
            transient = (transient_frac > 0
                         and b in transient_buckets
                         and rng.random() < transient_frac)
            n_transient += int(transient)
            jobs.append(one_request(sim, sem, latencies, failures,
                                    violations, transient=transient,
                                    index=i))
        say(f"streaming {n_requests} measured requests "
            f"({n_transient} transient, concurrency {concurrency})")
        t_meas0 = time.monotonic()
        await asyncio.gather(*jobs)
        measure_s = time.monotonic() - t_meas0
        say(f"measured phase: {measure_s:.1f}s, "
            f"{len(failures)} failures")

        # -- phase 4: drain burst (no-loss proof) ---------------------
        nb = (len(buckets) * max_occupancy if drain_burst is None
              else drain_burst)
        burst_lat, burst_fail, burst_viol = [], [], []
        burst = [one_request(pool[buckets[i % len(buckets)]][0], sem,
                             burst_lat, burst_fail, burst_viol)
                 for i in range(nb)]
        completed0 = server.stats()["completed_total"]
        burst_tasks = [asyncio.ensure_future(j) for j in burst]
        # Drain only once every burst request is past admission (over
        # TCP that takes a round-trip): the no-loss claim is about
        # ACCEPTED requests, and draining earlier would just reject
        # them at the door.
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            done = server.stats()["completed_total"] - completed0
            if done + server.in_service >= nb:
                break
            await asyncio.sleep(0.002)
        drain_task = asyncio.ensure_future(server.drain())
        await asyncio.gather(*burst_tasks)
        await drain_task
        stats = server.stats()
        drain_burst_ok = (len(burst_lat) + len(burst_fail) == nb
                          and not burst_fail and not burst_viol)
        say(f"drain complete; burst ok={drain_burst_ok}")
    finally:
        if tcp is not None:
            await tcp.close()
        await server.stop()

    backend = ((server.boot_manifest.get("backend") or {})
               .get("platform")) or "cpu"
    zero_rate = stats.get("zero_compile_rate_after_warm")
    record = {
        "bench": "serve-soak", "schema": SCHEMA,
        "backend": backend, "transport": transport, "runner": cfg.runner,
        "aot_pack": False,
        "n_requests": n_requests, "n_ok": len(latencies),
        "n_failed": len(failures),
        "n_transient": n_transient,
        "transient_frac": transient_frac,
        "n_warmup": n_warmup, "n_drain_burst": nb,
        "buckets": list(buckets), "lanes": lanes,
        "mechs_per_bucket": mechs_per_bucket,
        "max_occupancy": max_occupancy, "concurrency": concurrency,
        "seed": seed,
        "schema_violations": len(violations) + len(warm_viol),
        "warmup": {"prewarm": prewarm,
                   "requests": n_warmup,
                   "failed": len(warm_fail)},
        "serve": {
            "p50_s": _percentile(latencies, 50),
            "p99_s": _percentile(latencies, 99),
            "mean_s": (float(np.mean(latencies)) if latencies
                       else None),
            "throughput_rps": (len(latencies) / measure_s
                               if measure_s > 0 else None),
            "zero_compile_rate": zero_rate,
            "mean_occupancy": stats.get("mean_occupancy"),
            "flushes": stats.get("flushes"),
            "flushes_after_warm": stats.get("flushes_after_warm"),
            "compiles_after_warm": stats.get("compiles_after_warm"),
            "rejects": stats.get("rejected_total"),
            "drain_burst_ok": bool(drain_burst_ok),
        },
        "server_stats": stats,
        "failures": failures[:10],
        "violations": (violations + warm_viol)[:10],
        "wall_s": time.monotonic() - t_wall0,
        "manifest": server.boot_manifest,
    }
    return record


def run_soak(out_path: Optional[str] = None, **kwargs) -> dict:
    """Synchronous entry: run :func:`soak_async` (the coalescer lowers
    every mechanism into its ABI bucket: packing is the point of the
    service) and optionally write the record to ``out_path``."""
    record = asyncio.run(soak_async(**kwargs))
    if out_path:
        with open(out_path, "w") as fh:
            json.dump(record, fh, indent=1)
    return record


CHAOS_SCHEMA = "pycatkin-serve-chaos/v1"


def _free_port() -> int:
    """Reserve an ephemeral port for the supervised router: it must sit
    on a fixed address across incarnations so reconnecting clients find
    the rebooted process."""
    import socket
    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _timeout_flags(timeouts) -> list:
    """The router command line's flags for a timeouts mapping."""
    out = []
    for cls, sec in sorted((timeouts or {}).items()):
        out += [f"--timeout-{cls}", repr(float(sec))]
    return out


async def chaos_drill_async(n_requests: int = 24, bucket: int = 16,
                            lanes: int = 3, mechs: int = 4,
                            n_replicas: int = 3, kill: int = 2,
                            max_occupancy: int = 4, seed: int = 0,
                            with_pack: bool = True,
                            router_crash: bool = False,
                            work_dir: Optional[str] = None,
                            verbose: bool = False, device=None,
                            timeouts=None) -> dict:
    """The serve tier's chaos drill, on ``device`` (None: the CUDA card;
    ``"cpu"``):

    1. **baseline** -- every request of the drill grid is answered by an
       undisturbed in-process server on ``device``; the canonical
       answers are the bitwise-identity reference. On a card that
       server's start builds (or loads) the kernel library, so the
       replicas only load it; there is no warm-up to run (the JAX
       drill's fills the AOT cache it exports as the boot pack).
    2. **fleet** -- ``n_replicas`` replica processes on the same device
       (``python -m pycatkin_tpu_torch.serve --device ...``) under a
       :class:`.fleet.ReplicaSupervisor`, fronted by a
       :class:`.router.SweepRouter`; the same grid streams through the
       router over TCP (every 4th request ``interactive``, so hedged
       dispatch runs too). Each replica on a card loads the kernel
       library before its serving line: the port's counterpart of the
       JAX package's pack-warmed boot, which ``with_pack`` selects there.
       Here every replica boots so, and ``with_pack`` is accepted for the
       JAX signature and recorded, but changes nothing.
    3. **chaos** -- once a third of the stream has completed, a fault
       plan (O_EXCL ticket budgets under ``work_dir``) SIGKILLs ``kill``
       of the replicas at their ``router:replica:<i>`` sites and tears
       one dispatch line and resets one connection at
       ``router:dispatch:<i>``. In-flight requests must fail over.
    4. **audit** -- zero lost requests, every answer bitwise identical to
       the baseline, the router's duplicate-suppression audit has zero
       mismatches, killed replicas restarted (incarnation >= 2), each
       restarted replica re-verified with one direct sweep, and no
       replica's flush built or loaded the kernel library. The record's
       ``launches`` holds the kernel launches of the baseline server and
       the sum of the routable replicas' own (each counted in its
       process since its start, so a killed incarnation's are lost).

    ``router_crash=True`` also kills the front router: it runs as a
    journal-backed subprocess under a ``FleetConfig(role="router")``
    supervisor on a fixed port, every drill request carries an
    ``idempotency_key``, and the fault plan SIGKILLs the router at the
    ``router:front`` site mid-stream on top of the replica kills. The
    reconnecting client resubmits its unanswered keyed requests; the
    rebooted router replays its journal. The audit then also fetches
    every key's journaled answer (the ``result`` op) and requires it
    bitwise identical to the baseline. The dispatch-level faults move
    into the router process's own plan (``--fault-plan``, with its own
    ticket directory: parent and child budgets must not share spec
    indices).

    ``timeouts`` (class -> seconds) goes to the router and the client
    (:func:`.protocol.request_timeouts`).
    """
    import tempfile

    from ..models.synthetic import synthetic_system_for_bucket
    from ..parallel.batch import resolve_device
    from ..robustness import faults
    from ..utils.io import system_to_dict
    from .client import SweepClient, TcpSweepClient, sweep_payload
    from .fleet import FleetConfig, ReplicaSupervisor
    from .protocol import ServeConfig
    from .router import RouterConfig, SweepRouter, _canonical
    from .server import SweepServer

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    t_wall0 = time.monotonic()

    def say(msg):
        if verbose:
            print(f"chaos-drill: {msg}", flush=True)

    sims = [synthetic_system_for_bucket(
                bucket, seed=int(rng.integers(0, 2**31)), device=device)
            for _ in range(mechs)]
    mech_dicts = [system_to_dict(s) for s in sims]
    plan_grid = [(i % mechs,
                  [float(t) for t in rng.uniform(480.0, 520.0,
                                                 size=lanes)],
                  "interactive" if i % 4 == 0 else "standard")
                 for i in range(n_requests)]

    own_td = None
    if work_dir is None:
        own_td = tempfile.TemporaryDirectory(prefix="pycatkin_chaos_")
        work_dir = own_td.name
    tickets = os.path.join(work_dir, "fault_tickets")
    endpoints_path = os.path.join(work_dir, "endpoints.json")
    journal_dir = os.path.join(work_dir, "journal")
    router_tickets = os.path.join(work_dir, "fault_tickets_router")
    supervisor = router = router_sup = client = None
    router_events: list = []
    walls: dict = {}
    drill_ok = False
    try:
        # -- phase 1: undisturbed baseline ----------------------------
        say(f"baseline: {n_requests} requests, in-process on {dev}")
        t0 = time.monotonic()
        base_cfg = ServeConfig(port=0, max_occupancy=max_occupancy,
                               device=device)
        base = await SweepServer(base_cfg).start(listen=False)
        bclient = SweepClient(base)
        sem = asyncio.Semaphore(8)

        async def base_one(i):
            mi, T, cls = plan_grid[i]
            async with sem:
                return await bclient.sweep(mech_dicts[mi], T,
                                           deadline_class=cls)
        base_resps = await asyncio.gather(
            *(base_one(i) for i in range(n_requests)))
        bad = [r for r in base_resps if not r.get("ok")]
        if bad:
            raise RuntimeError(f"baseline run failed: {bad[:3]}")
        baseline = [_canonical(r) for r in base_resps]
        base_launches = base.launches()
        backend = ((base.boot_manifest.get("backend") or {})
                   .get("platform")) or "cpu"
        await base.drain()
        walls["baseline_s"] = time.monotonic() - t0

        # -- phase 2: fleet + router ----------------------------------
        t0 = time.monotonic()
        cmd = [sys.executable, "-m", "pycatkin_tpu_torch.serve",
               "--host", "127.0.0.1", "--port", "0",
               "--max-occupancy", str(max_occupancy),
               "--device", dev.type]
        # Replicas on the CPU share its cores: one thread each, or they
        # spend the drill contending for them.
        renv = {"OMP_NUM_THREADS": "1"} if dev.type == "cpu" else {}
        supervisor = ReplicaSupervisor(FleetConfig(
            n_replicas=n_replicas, command=cmd, env=renv,
            endpoints_file=endpoints_path if router_crash else None))
        say(f"booting {n_replicas} replicas on {dev.type}")
        await supervisor.start()
        walls["fleet_boot_s"] = time.monotonic() - t0
        if router_crash:
            # The router is a supervised subprocess on a fixed port:
            # clients must reconnect to the same address after its
            # SIGKILL. Dispatch-level chaos rides on its command line
            # (with its own ticket directory: spec indices must not
            # collide with the parent plan's), and the journal's segment
            # cap is raised so that drill answers never compact out of
            # the dedup window mid-audit.
            dispatch_specs = [
                {"site": "router:dispatch:*", "kind": "conn-reset",
                 "times": 1},
                {"site": "router:dispatch:*", "kind": "torn-line",
                 "times": 1}]
            router_port = _free_port()
            rcmd = [sys.executable, "-m", "pycatkin_tpu_torch.serve",
                    "--router", "--host", "127.0.0.1",
                    "--port", str(router_port),
                    "--fleet-file", endpoints_path,
                    "--journal-dir", journal_dir,
                    "--segment-bytes", str(1 << 30),
                    "--fault-plan", json.dumps(
                        {"specs": dispatch_specs,
                         "state_dir": router_tickets}),
                    *_timeout_flags(timeouts)]
            router_sup = ReplicaSupervisor(FleetConfig(role="router",
                                                       command=rcmd))
            router_sup.add_listener(
                lambda info: router_events.append(
                    (time.monotonic(), dict(info))))
            say(f"booting the journal-backed router process on port "
                f"{router_port}")
            t0 = time.monotonic()
            await router_sup.start()
            walls["router_boot_s"] = time.monotonic() - t0
        else:
            router = await SweepRouter(
                supervisor, RouterConfig(timeouts=timeouts)).start()
            router_port = router.port
        client = await TcpSweepClient("127.0.0.1", router_port,
                                      timeouts=timeouts).connect()

        # -- phase 3: stream + mid-stream chaos -----------------------
        t0 = time.monotonic()
        results: list = [None] * n_requests
        done_box = {"n": 0}

        async def fleet_one(i):
            mi, T, cls = plan_grid[i]
            async with sem:
                resp = await client.request(sweep_payload(
                    mech_dicts[mi], T, deadline_class=cls,
                    req_id=f"q{i}",
                    idempotency_key=(f"q{i}" if router_crash
                                     else None)))
            results[i] = resp
            done_box["n"] += 1

        say(f"streaming {n_requests} requests through the router")
        drive = asyncio.ensure_future(asyncio.gather(
            *(fleet_one(i) for i in range(n_requests))))
        trigger = max(1, n_requests // 3)
        while done_box["n"] < trigger and not drive.done():
            await asyncio.sleep(0.01)
        specs = [{"site": f"router:replica:{i}",
                  "kind": "replica-crash", "times": 1}
                 for i in range(kill)]
        if router_crash:
            # Dispatch faults live in the router process's own plan;
            # the parent enacts the kills, the router's included.
            specs += [{"site": "router:front", "kind": "router-crash",
                       "times": 1}]
        else:
            specs += [{"site": "router:dispatch:*",
                       "kind": "conn-reset", "times": 1},
                      {"site": "router:dispatch:*", "kind": "torn-line",
                       "times": 1}]
        chaos = faults.FaultPlan(specs, state_dir=tickets)
        say(f"chaos: SIGKILLing {kill} of {n_replicas} replicas"
            f"{' and the front router' if router_crash else ''} "
            f"mid-stream")
        with faults.fault_scope(chaos):
            await drive
        walls["stream_s"] = time.monotonic() - t0
        kills_fired = [e for e in chaos.log
                       if e["kind"] == "replica-crash"]
        router_kills = [e for e in chaos.log
                        if e["kind"] == "router-crash"]

        # -- phase 4: audit -------------------------------------------
        t0 = time.monotonic()
        say("waiting for the killed replicas to reboot")
        reboot_deadline = time.monotonic() + 120.0
        killed = [supervisor.replicas[i] for i in range(kill)]
        while time.monotonic() < reboot_deadline and any(
                r.state != "abandoned"
                and (r.incarnation < 2 or not r.routable)
                for r in killed):
            await asyncio.sleep(0.1)

        durable_audit = None
        if router_crash:
            say("waiting for the rebooted router and its journal replay")
            rrep = router_sup.replicas[0]
            while time.monotonic() < reboot_deadline \
                    and rrep.state != "abandoned" \
                    and (rrep.incarnation < 2 or not rrep.routable):
                await asyncio.sleep(0.1)
            # Recovery wall: the supervisor's down event (router died)
            # to the next up event (rebooted, registered, routable).
            recovery_s = None
            down_t = None
            for t, ev in router_events:
                if ev["event"] == "down" and down_t is None:
                    down_t = t
                elif ev["event"] == "up" and down_t is not None:
                    recovery_s = t - down_t
                    break
            # The journal replay must have finished before the per-key
            # audit (a key still in flight would fail the fetch).
            replay = {}
            durable = {}
            while time.monotonic() < reboot_deadline:
                st = await client.stats()
                durable = ((st.get("stats") or {}).get("durable")
                           if st.get("ok") else None) or {}
                replay = durable.get("replay") or {}
                if durable and not replay.get("active"):
                    break
                await asyncio.sleep(0.1)
            # Every key's journaled answer, fetched over the wire, must
            # be bitwise identical to the baseline: one key, one answer.
            result_bad = []
            for i in range(n_requests):
                rr = await client.fetch_result(f"q{i}")
                if not rr.get("ok") or _canonical(rr) != baseline[i]:
                    result_bad.append(
                        {"key": f"q{i}",
                         "error": rr.get("error"),
                         "mismatch": bool(rr.get("ok"))})
            durable_audit = {
                "router_kills_fired": len(router_kills),
                "router_incarnations": rrep.incarnation,
                "router_recovery_s": recovery_s,
                "journal_replay_s": replay.get("wall_s"),
                "replay": replay,
                "duplicates_served": durable.get("duplicates_served"),
                "coalesced": durable.get("coalesced"),
                "client_reconnects": client.reconnects,
                "client_acks": client.acks,
                "result_fetch_bad": result_bad,
            }

        n_ok = sum(1 for r in results if r and r.get("ok"))
        mismatches = [i for i, r in enumerate(results)
                      if r and r.get("ok")
                      and _canonical(r) != baseline[i]]
        replica_stats = {}
        reverify_bad = []
        for r in supervisor.replicas:
            if not r.routable:
                continue
            rc = await TcpSweepClient("127.0.0.1", r.port,
                                      timeouts=timeouts).connect()
            try:
                if r.incarnation > 1:
                    # One direct sweep through the rebooted replica: its
                    # answer must match the baseline bit for bit.
                    mi, T, cls = plan_grid[0]
                    resp = await rc.request(sweep_payload(
                        mech_dicts[mi], T, deadline_class=cls,
                        req_id=f"verify{r.idx}"))
                    if not resp.get("ok") or \
                            _canonical(resp) != baseline[0]:
                        reverify_bad.append(r.idx)
                st = await rc.stats()
                replica_stats[str(r.idx)] = (st.get("stats")
                                             if st.get("ok") else None)
            finally:
                await rc.close()
        zero_compile_bad = []
        replica_launches: dict = {}
        for idx, st in replica_stats.items():
            if not st or not st.get("flushes") \
                    or st.get("flushes_with_compiles"):
                zero_compile_bad.append(
                    {"replica": idx,
                     "flushes": st.get("flushes") if st else None,
                     "flushes_with_compiles":
                         st.get("flushes_with_compiles")
                         if st else None})
            for name, n, ln, c in (st or {}).get("launches") or []:
                key = (name, n, ln)
                replica_launches[key] = replica_launches.get(key, 0) + c
        if router_crash:
            st = await client.stats()
            rstats = (st.get("stats") or {}) if st.get("ok") else {}
        else:
            rstats = router.stats()
        await client.close()
        if router is not None:
            await router.drain()
        if router_sup is not None:
            await router_sup.stop()
        await supervisor.stop()
        walls["audit_s"] = time.monotonic() - t0
        drill_ok = True
    finally:
        if not drill_ok:
            # Best-effort teardown on the failure path, so that a
            # raising drill never strands replica processes.
            for closer in (client and client.close,
                           router and router.stop,
                           router_sup and router_sup.stop,
                           supervisor and supervisor.stop):
                if closer is None:
                    continue
                try:
                    await closer()
                except Exception:
                    pass
        if own_td is not None:
            own_td.cleanup()

    incarnations = [r.incarnation for r in supervisor.replicas]
    record = {
        "bench": "serve-chaos-drill", "schema": CHAOS_SCHEMA,
        "backend": backend, "device": dev.type,
        "with_pack": bool(with_pack),
        "router_crash": bool(router_crash),
        "durable": durable_audit,
        "n_requests": n_requests, "n_ok": n_ok,
        "n_failed": n_requests - n_ok,
        "bucket": bucket, "lanes": lanes, "mechs": mechs,
        "max_occupancy": max_occupancy, "seed": seed,
        "n_replicas": n_replicas, "kill": kill,
        "kills_fired": len(kills_fired),
        "chaos_log": chaos.log,
        "incarnations": incarnations,
        "launches": {
            "baseline": base_launches,
            "replicas": sorted([*k, c]
                               for k, c in replica_launches.items()),
        },
        "router": {
            "availability": rstats.get("availability"),
            "failover_p99_s": rstats.get("failover_p99_s"),
            "retries": rstats.get("retries"),
            "hedges": rstats.get("hedges"),
            "failovers": rstats.get("failovers"),
            "duplicates": rstats.get("duplicates"),
            "lost": n_requests - n_ok,
            "bitwise_mismatches": len(mismatches),
            "reverify_failed": reverify_bad,
            "zero_compile_violations": zero_compile_bad,
        },
        "router_stats": rstats,
        "replica_stats": replica_stats,
        "failures": [r.get("error") for r in results
                     if r and not r.get("ok")][:10],
        "walls": walls,
        "wall_s": time.monotonic() - t_wall0,
    }
    return record


def run_chaos_drill(out_path: Optional[str] = None,
                    time_limit_s: Optional[float] = None,
                    **kwargs) -> dict:
    """Synchronous entry of the chaos drill; optionally writes the
    record. ``time_limit_s`` bounds the whole drill: past it the drill
    stops its processes and raises ``TimeoutError``.

    Every deadline class's request timeout is widened to the
    ``standard`` budget for the drill, unless the caller's ``timeouts``
    names it: a killed replica's reboot takes seconds to tens of seconds
    (a card's context and kernel library, or a CPU's slow flushes), so
    the production ``interactive`` budget would turn reboot time into
    fake request loss -- the drill gates on loss under chaos, not on
    latency."""
    from .protocol import DEADLINE_CLASSES, request_timeout_for
    timeouts = {cls: request_timeout_for("standard")
                for cls in DEADLINE_CLASSES}
    timeouts.update(kwargs.pop("timeouts", None) or {})
    record = asyncio.run(asyncio.wait_for(
        chaos_drill_async(timeouts=timeouts, **kwargs), time_limit_s))
    if out_path:
        with open(out_path, "w") as fh:
            json.dump(record, fh, indent=1)
    return record


def check_chaos_record(record: dict) -> list:
    """Gate a chaos-drill record; returns failure strings (empty =
    pass)."""
    problems = []
    router = record.get("router") or {}
    if router.get("lost"):
        problems.append(f"{router['lost']} of "
                        f"{record.get('n_requests')} requests lost "
                        f"during the drill: {record.get('failures')}")
    if router.get("bitwise_mismatches"):
        problems.append(f"{router['bitwise_mismatches']} answers "
                        f"differ bitwise from the undisturbed "
                        f"baseline run")
    dups = router.get("duplicates") or {}
    if dups.get("mismatched"):
        problems.append(f"duplicate-suppression audit: "
                        f"{dups['mismatched']} suppressed answers "
                        f"were NOT bit-identical to the delivered one")
    if record.get("kills_fired", 0) < record.get("kill", 0):
        problems.append(f"chaos plan fired only "
                        f"{record.get('kills_fired')} of "
                        f"{record.get('kill')} replica kills")
    incs = record.get("incarnations") or []
    restarted = sum(1 for i in incs[:record.get("kill", 0)] if i >= 2)
    if restarted < record.get("kill", 0):
        problems.append(f"only {restarted} of {record.get('kill')} "
                        f"killed replicas came back "
                        f"(incarnations={incs})")
    if router.get("reverify_failed"):
        problems.append(f"rebooted replicas "
                        f"{router['reverify_failed']} answered the "
                        f"verification sweep wrong")
    if router.get("zero_compile_violations"):
        problems.append(f"warm-booted replicas built or loaded the "
                        f"kernel library during flushes: "
                        f"{router['zero_compile_violations']}")
    if record.get("router_crash"):
        durable = record.get("durable")
        if not durable:
            problems.append("router-crash drill produced no durable "
                            "audit")
            return problems
        if not durable.get("router_kills_fired"):
            problems.append("the router-crash fault never fired")
        if (durable.get("router_incarnations") or 0) < 2:
            problems.append(
                f"the killed router never came back (incarnations="
                f"{durable.get('router_incarnations')})")
        if durable.get("result_fetch_bad"):
            bad = durable["result_fetch_bad"]
            problems.append(
                f"{len(bad)} journaled answers missing or not "
                f"bitwise identical to the baseline: {bad[:3]}")
        replay = durable.get("replay") or {}
        if replay.get("failed"):
            problems.append(f"journal replay failed to re-answer "
                            f"{replay['failed']} accepted requests")
    return problems


DURABLE_SCHEMA = "pycatkin-serve-durable-smoke/v1"


def _write_json_file(path: str, obj) -> None:
    with open(path, "w") as fh:
        json.dump(obj, fh)


def _append_bytes(path: str, data: bytes) -> None:
    with open(path, "ab") as fh:
        fh.write(data)


async def durable_smoke_async(n_keys: int = 6, lanes: int = 2,
                              work_dir: Optional[str] = None,
                              verbose: bool = False) -> dict:
    """The durable-serving smoke: a miniature journal round trip plus a
    router-kill replay over a stub replica (no solver, no device), so it
    runs in seconds.

    1. **journal round trip** -- a tiny-segment :class:`.durable.
       RequestJournal` takes accepted / answered records through
       rotation and compaction, gets its tail torn mid-record (a kill
       mid-append), and must replay losing nothing but the torn -- never
       acknowledged -- final line;
    2. **router-kill replay** -- router A (journal-backed, fronting a
       deterministic stub replica through a :class:`.fleet.FileFleet`
       endpoints file) answers ``n_keys`` keyed sweeps; two more keys
       are journaled accepted but unanswered, as a router killed between
       the fsynced ack and the dispatch leaves them; router A stops
       without draining. Router B boots over the same journal: it must
       re-dispatch exactly the pending backlog, serve a resubmitted key
       bitwise from the journal, and answer a ``result`` fetch
       identically.
    """
    import tempfile

    from .client import TcpSweepClient, sweep_payload
    from .durable import RequestJournal
    from .fleet import FileFleet
    from .protocol import PROTOCOL
    from .router import RouterConfig, SweepRouter, _canonical

    t_wall0 = time.monotonic()

    def say(msg):
        if verbose:
            print(f"durable-smoke: {msg}", flush=True)

    own_td = None
    if work_dir is None:
        own_td = tempfile.TemporaryDirectory(
            prefix="pycatkin_durable_")
        work_dir = own_td.name

    # -- phase 1: journal round trip ----------------------------------
    n_rt = 8
    jdir1 = os.path.join(work_dir, "roundtrip")
    j = await asyncio.to_thread(RequestJournal, jdir1, 128)
    for i in range(n_rt):
        await asyncio.to_thread(j.record_accepted, f"rt{i}",
                                {"op": "sweep", "n": i})
        await asyncio.to_thread(
            j.record_answered, f"rt{i}",
            {"ok": True, "result": {"n": i}, "quarantine": [],
             "lanes": 1, "id": f"rt{i}"})
    await asyncio.to_thread(j.record_accepted, "rt-pending",
                            {"op": "sweep", "n": -1})
    st1 = j.stats()
    # Tear the active segment's tail mid-record, as a SIGKILL between
    # write and fsync would; the torn key was never acknowledged, so
    # replay must drop it and keep everything before it.
    torn_path = os.path.join(
        jdir1, f"requests_{st1['active_segment']:05d}.jsonl")
    await asyncio.to_thread(_append_bytes, torn_path,
                            b'{"kind": "accepted", "key": "torn')
    j2 = await asyncio.to_thread(RequestJournal, jdir1)
    last = f"rt{n_rt - 1}"
    roundtrip = {
        "n": n_rt,
        "rotations": st1["rotations"],
        "compacted_segments": st1["compacted_segments"],
        # Compaction deletes fully answered sealed segments with their
        # answered records (the dedup window's bound), so only answers
        # in segments still on disk replay. The last answer always
        # lands in a segment compaction never ran on, so its survival
        # is the deterministic gate.
        "answers_survived": sum(
            1 for i in range(n_rt)
            if (j2.answered_response(f"rt{i}") or {}).get("result")
            == {"n": i}),
        "last_answer_survived": (
            (j2.answered_response(last) or {}).get("result")
            == {"n": n_rt - 1}),
        "pending_survived": [k for k, _ in j2.unanswered()],
        "torn_key_leaked": j2.is_accepted("torn"),
        "replayed_records": j2.stats()["replayed_records"],
    }
    say(f"roundtrip: {roundtrip}")

    # -- phase 2: stub fleet + journal-backed router A ----------------
    async def stub_handler(reader, writer):
        # A wire-compatible replica whose answer is a pure function of
        # the request's conditions: bitwise identity across dispatches
        # and router incarnations is checkable with canonical_answer.
        try:
            while True:
                line = await reader.readline()
                if not line:
                    break
                try:
                    req = json.loads(line)
                except ValueError:
                    continue
                if req.get("op") == "ping":
                    resp = {"protocol": PROTOCOL, "id": req.get("id"),
                            "ok": True, "pong": True}
                else:
                    T = list((req.get("conditions") or {})
                             .get("T") or [])
                    resp = {"protocol": PROTOCOL, "id": req.get("id"),
                            "ok": True,
                            "result": {"success": [True] * len(T),
                                       "T": T},
                            "quarantine": [], "lanes": len(T)}
                writer.write((json.dumps(resp) + "\n").encode())
                await writer.drain()
        except (ConnectionError, OSError):
            pass
        finally:
            # Server.wait_closed waits for this connection (Python 3.12).
            writer.close()

    stub = await asyncio.start_server(stub_handler, "127.0.0.1", 0)
    stub_port = stub.sockets[0].getsockname()[1]
    endpoints_path = os.path.join(work_dir, "endpoints.json")
    await asyncio.to_thread(_write_json_file, endpoints_path, {
        "endpoints": [{"idx": 0, "incarnation": 1,
                       "host": "127.0.0.1", "port": stub_port}]})
    jdir = os.path.join(work_dir, "journal")
    router_a = router_b = client = None
    try:
        router_a = await SweepRouter(
            FileFleet(endpoints_path),
            RouterConfig(port=0, journal_dir=jdir)).start()
        client = await TcpSweepClient("127.0.0.1",
                                      router_a.port).connect()
        say(f"router A answering {n_keys} keyed sweeps")
        baseline = {}
        for i in range(n_keys):
            resp = await client.request(sweep_payload(
                {"stub": True}, [500.0 + i] * lanes,
                req_id=f"s{i}", idempotency_key=f"k{i}"))
            if not resp.get("ok"):
                raise RuntimeError(f"stub sweep failed: {resp}")
            baseline[f"k{i}"] = _canonical(resp)
        acks_a = client.acks
        await client.close()
        client = None
        # A router killed between the fsynced ack and the dispatch: the
        # journal holds accepted records no answer ever followed.
        for i in range(2):
            await asyncio.to_thread(
                router_a._journal.record_accepted, f"pending{i}",
                {"op": "sweep", "mechanism": {"stub": True},
                 "conditions": {"T": [600.0 + i] * lanes},
                 "deadline_class": "standard",
                 "idempotency_key": f"pending{i}"})
        await router_a.stop()   # no drain: the "kill"
        router_a = None

        # -- phase 3: router B replays the journal --------------------
        say("booting router B over the same journal")
        t0 = time.monotonic()
        router_b = await SweepRouter(
            FileFleet(endpoints_path),
            RouterConfig(port=0, journal_dir=jdir)).start()
        recovery_s = time.monotonic() - t0
        deadline = time.monotonic() + 30.0
        replay = {}
        while time.monotonic() < deadline:
            replay = router_b.stats()["durable"]["replay"]
            if not replay.get("active"):
                break
            await asyncio.sleep(0.01)
        client = await TcpSweepClient("127.0.0.1",
                                      router_b.port).connect()
        # A duplicate of an answered key must come back bitwise from the
        # journal, not from a fresh dispatch.
        dup = await client.request(sweep_payload(
            {"stub": True}, [500.0] * lanes, req_id="dup0",
            idempotency_key="k0"))
        fetch = await client.fetch_result("k1")
        pend = await client.fetch_result("pending0")
        bstats = router_b.stats()["durable"]
        await client.close()
        client = None
        await router_b.drain()
        router_b = None
    finally:
        for closer in (client and client.close,
                       router_a and router_a.stop,
                       router_b and router_b.stop):
            if closer is None:
                continue
            try:
                await closer()
            except Exception:
                pass
        stub.close()
        await stub.wait_closed()
        if own_td is not None:
            own_td.cleanup()

    record = {
        "bench": "serve-durable-smoke", "schema": DURABLE_SCHEMA,
        "n_keys": n_keys, "lanes": lanes,
        "roundtrip": roundtrip,
        "replay": dict(replay, pending_expected=2,
                       router_recovery_s=recovery_s),
        "dup": {
            "served": bstats.get("duplicates_served"),
            "bitwise_ok": bool(dup.get("ok")
                               and _canonical(dup) == baseline["k0"]),
            "result_ok": bool(fetch.get("ok")
                              and _canonical(fetch) == baseline["k1"]),
            "replayed_pending_ok": bool(pend.get("ok")),
            "acks": acks_a,
        },
        "journal": bstats.get("journal"),
        "wall_s": time.monotonic() - t_wall0,
    }
    return record


def run_durable_smoke(out_path: Optional[str] = None,
                      **kwargs) -> dict:
    """Synchronous entry of the durable smoke; optionally writes the
    record."""
    record = asyncio.run(durable_smoke_async(**kwargs))
    if out_path:
        with open(out_path, "w") as fh:
            json.dump(record, fh, indent=1)
    return record


def check_durable_record(record: dict) -> list:
    """Gate a durable-smoke record; returns failure strings (empty =
    pass)."""
    problems = []
    rt = record.get("roundtrip") or {}
    if not rt.get("rotations"):
        problems.append("journal round-trip never rotated a segment")
    if not rt.get("compacted_segments"):
        problems.append("journal round-trip never compacted a "
                        "fully-answered segment")
    if not rt.get("last_answer_survived"):
        problems.append("the newest journaled answer (whose segment "
                        "was never compacted) did not survive replay")
    if rt.get("pending_survived") != ["rt-pending"]:
        problems.append(f"pending keys after replay: "
                        f"{rt.get('pending_survived')} "
                        f"(expected ['rt-pending'])")
    if rt.get("torn_key_leaked"):
        problems.append("a torn (never-acknowledged) final record "
                        "leaked into the replayed journal")
    replay = record.get("replay") or {}
    if (replay.get("total") != replay.get("pending_expected")
            or replay.get("failed")
            or replay.get("done") != replay.get("total")):
        problems.append(f"router-kill replay did not re-answer the "
                        f"journal backlog: {replay}")
    dup = record.get("dup") or {}
    if not dup.get("bitwise_ok"):
        problems.append("a duplicate keyed request was not answered "
                        "bitwise from the journal")
    if not dup.get("result_ok"):
        problems.append("the result op did not return the journaled "
                        "answer bitwise")
    if not dup.get("replayed_pending_ok"):
        problems.append("a replayed accepted-but-unanswered key has "
                        "no fetchable answer")
    if not dup.get("served"):
        problems.append("the duplicates-served counter never moved")
    if not dup.get("acks"):
        problems.append("the client received no durability ack lines")
    return problems


def check_soak_record(record: dict, p99_budget_s: float = 30.0,
                      expect_zero_compiles: bool = True,
                      expect_warm_compiled_zero: bool = False) -> list:
    """Gate a soak record; returns a list of failure strings (empty =
    pass)."""
    problems = []
    serve = record.get("serve") or {}
    if record.get("n_failed"):
        problems.append(f"{record['n_failed']} measured requests "
                        f"failed: {record.get('failures')}")
    if record.get("n_ok") != record.get("n_requests"):
        problems.append(f"only {record.get('n_ok')} of "
                        f"{record.get('n_requests')} measured requests "
                        f"returned ok")
    if record.get("schema_violations"):
        problems.append(f"{record['schema_violations']} responses "
                        f"missing manifest/telemetry/quarantine: "
                        f"{record.get('violations')}")
    if expect_zero_compiles and serve.get("zero_compile_rate") != 1.0:
        problems.append(f"zero-compile rate after warmup is "
                        f"{serve.get('zero_compile_rate')} "
                        f"(compiles_after_warm="
                        f"{serve.get('compiles_after_warm')}), not 1.0")
    p99 = serve.get("p99_s")
    if p99 is None or p99 > p99_budget_s:
        problems.append(f"p99 latency {p99}s over budget "
                        f"{p99_budget_s}s")
    if not serve.get("drain_burst_ok"):
        problems.append("graceful drain lost or failed burst requests")
    if (expect_warm_compiled_zero
            and ((record.get("warmup") or {}).get("prewarm") or {})
            .get("compiled") != 0):
        problems.append(
            f"pack-warmed boot still compiled "
            f"{record['warmup']['prewarm'].get('compiled')} programs "
            f"(expected a warm kernel library)")
    return problems


def main(argv=None) -> int:
    """``python -m pycatkin_tpu_torch.serve.soak``: run the soak, print
    its record's ``serve`` block and the gate's verdict, optionally write
    the record (``--json``); exits 1 when ``--gate`` is given and
    :func:`check_soak_record` finds a problem. ``--chaos`` runs the
    chaos drill instead (the router killed too unless
    ``--no-router-crash``; ``--bucket`` by default 16 on the CPU, as the
    JAX package's, and 32 on the card, the smallest bucket whose sweeps
    launch the kernels; a drill on the card whose replicas launched no
    kernel says so on stderr) and ``--durable`` the durable smoke; both
    exit 1 when their gate finds a problem."""
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m pycatkin_tpu_torch.serve.soak",
        description="Soak a sweep server, or drill its fleet tier.")
    ap.add_argument("--requests", type=int, default=None,
                    help="measured requests (default 1000; --chaos 24)")
    ap.add_argument("--buckets", default="16,32,128")
    ap.add_argument("--lanes", type=int, default=None,
                    help="lanes a request (default 4; --chaos 3)")
    ap.add_argument("--mechs-per-bucket", type=int, default=6)
    ap.add_argument("--max-occupancy", type=int, default=None,
                    help="default 8; --chaos 4")
    ap.add_argument("--concurrency", type=int, default=16)
    ap.add_argument("--transport", choices=("inproc", "tcp"),
                    default="inproc")
    ap.add_argument("--transient-frac", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--json", default=None, help="write the record here")
    ap.add_argument("--gate", action="store_true",
                    help="exit 1 when check_soak_record finds a problem")
    ap.add_argument("--chaos", action="store_true",
                    help="run the fleet's chaos drill")
    ap.add_argument("--no-router-crash", action="store_true",
                    help="--chaos: kill replicas only, not the router")
    ap.add_argument("--bucket", type=int, default=None,
                    help="--chaos: the drill's ABI bucket (default 16 "
                         "on the CPU, 32 on the card)")
    ap.add_argument("--replicas", type=int, default=3,
                    help="--chaos: replica processes")
    ap.add_argument("--kill", type=int, default=2,
                    help="--chaos: replicas killed mid-stream")
    ap.add_argument("--durable", action="store_true",
                    help="run the durable-serving smoke")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    if args.chaos:
        bucket = args.bucket
        if bucket is None:
            bucket = 16 if args.device == "cpu" else 32
        record = run_chaos_drill(
            out_path=args.json, n_requests=args.requests or 24,
            bucket=bucket, lanes=args.lanes or 3,
            n_replicas=args.replicas, kill=args.kill,
            max_occupancy=args.max_occupancy or 4, seed=args.seed,
            router_crash=not args.no_router_crash, device=args.device,
            verbose=args.verbose)
        problems = check_chaos_record(record)
        if record["device"] == "cuda" and not record["launches"]["replicas"]:
            print(f"chaos-drill: the replicas launched no kernel at "
                  f"bucket {bucket} (its sweeps never reach an LU; "
                  f"bucket 32 does)", file=sys.stderr)
        print(json.dumps({"router": record["router"],
                          "durable": record["durable"],
                          "incarnations": record["incarnations"],
                          "launches": record["launches"],
                          "walls": record["walls"],
                          "wall_s": record["wall_s"],
                          "problems": problems}))
        return 1 if problems else 0
    if args.durable:
        record = run_durable_smoke(out_path=args.json,
                                   verbose=args.verbose)
        problems = check_durable_record(record)
        print(json.dumps({"roundtrip": record["roundtrip"],
                          "replay": record["replay"],
                          "dup": record["dup"],
                          "wall_s": record["wall_s"],
                          "problems": problems}))
        return 1 if problems else 0
    record = run_soak(
        out_path=args.json, n_requests=args.requests or 1000,
        buckets=tuple(int(b) for b in args.buckets.split(",")),
        lanes=args.lanes or 4, mechs_per_bucket=args.mechs_per_bucket,
        max_occupancy=args.max_occupancy or 8,
        concurrency=args.concurrency,
        transport=args.transport, transient_frac=args.transient_frac,
        seed=args.seed, device=args.device, verbose=args.verbose)
    problems = check_soak_record(record)
    print(json.dumps({"serve": record["serve"],
                      "n_transient": record["n_transient"],
                      "warmup": record["warmup"],
                      "wall_s": record["wall_s"],
                      "problems": problems}))
    return 1 if args.gate and problems else 0


if __name__ == "__main__":
    sys.exit(main())
