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
:func:`check_soak_record` gates it. The chaos drill and the durable
smoke need the router and the fleet, which are not ported yet
(ROADMAP.md Queue A).
"""

from __future__ import annotations

import asyncio
import json
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
    :func:`check_soak_record` finds a problem."""
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m pycatkin_tpu_torch.serve.soak",
        description="Soak a sweep server.")
    ap.add_argument("--requests", type=int, default=1000)
    ap.add_argument("--buckets", default="16,32,128")
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--mechs-per-bucket", type=int, default=6)
    ap.add_argument("--max-occupancy", type=int, default=8)
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
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    record = run_soak(
        out_path=args.json, n_requests=args.requests,
        buckets=tuple(int(b) for b in args.buckets.split(",")),
        lanes=args.lanes, mechs_per_bucket=args.mechs_per_bucket,
        max_occupancy=args.max_occupancy, concurrency=args.concurrency,
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
    import sys
    sys.exit(main())
