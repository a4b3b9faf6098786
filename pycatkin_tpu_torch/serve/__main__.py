"""``python -m pycatkin_tpu_torch.serve`` -- run a sweep server until
drained (SIGINT / SIGTERM trigger the graceful drain).

    python -m pycatkin_tpu_torch.serve [--host H] [--port P]
        [--runner inproc|elastic] [--work-dir D] [--max-occupancy K]
        [--device cuda|cpu]

The bound port is printed as a JSON line on stdout so a supervisor can
scrape it; a second JSON line with the server's stats follows the drain.
``--device`` defaults to the CUDA card, and the server refuses to start
without one. On the card it loads the kernel library before it prints
the serving line, and exits nonzero when the library does not build or
load.
``--runner elastic`` runs solo groups through the elastic scheduler's
worker processes.

``--router`` runs the front router instead (:mod:`.router`): a process
that holds no tensor and routes to the replica endpoints published in
``--fleet-file`` (by a :class:`.fleet.ReplicaSupervisor` with
``endpoints_file``), optionally journal-backed with ``--journal-dir``
so that a supervised router (``FleetConfig(role="router")``) replays
its accepted-but-unanswered backlog after a crash:

    python -m pycatkin_tpu_torch.serve --router --port P
        --fleet-file F [--journal-dir D] [--segment-bytes N]
        [--replay-concurrency N] [--timeout-interactive S]
        [--timeout-standard S] [--timeout-batch S] [--fault-plan JSON]

``--fault-plan`` is a fault plan's JSON form
(:meth:`..robustness.faults.FaultPlan.from_json`), active for the
router's whole life: how the chaos drill injects its dispatch faults.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import signal
import sys


async def _serve_until_drained(obj, running, first_line: dict) -> dict:
    """Print ``first_line``, then wait until a signal or a client's
    ``drain`` op has drained ``obj`` (``running()`` turns false)."""
    print(json.dumps(first_line), flush=True)
    loop = asyncio.get_running_loop()
    draining = asyncio.Event()

    def _trigger_drain():
        if not draining.is_set():
            draining.set()
            loop.create_task(obj.drain())

    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            loop.add_signal_handler(sig, _trigger_drain)
        except (NotImplementedError, OSError):
            pass
    while running():
        await asyncio.sleep(0.1)
    return obj.stats()


async def _amain(args) -> int:
    from .protocol import ServeConfig
    from .server import SweepServer

    cfg = ServeConfig(host=args.host, port=args.port, runner=args.runner,
                      work_dir=args.work_dir,
                      max_occupancy=args.max_occupancy, device=args.device)
    server = await SweepServer(cfg).start()
    stats = await _serve_until_drained(
        server, lambda: server._scheduler_task is not None,
        {"serving": True, "host": cfg.host, "port": server.port})
    print(json.dumps({"serving": False, "stats": stats}), flush=True)
    return 0


async def _amain_router(args) -> int:
    from ..robustness import faults
    from .fleet import FileFleet
    from .router import RouterConfig, SweepRouter

    if not args.fleet_file:
        print("--router requires --fleet-file", file=sys.stderr)
        return 2
    timeouts = {cls: sec for cls, sec in (
        ("interactive", args.timeout_interactive),
        ("standard", args.timeout_standard),
        ("batch", args.timeout_batch)) if sec is not None}
    cfg = RouterConfig(host=args.host or "127.0.0.1",
                       port=args.port or 0, journal_dir=args.journal_dir,
                       segment_bytes=args.segment_bytes,
                       replay_concurrency=args.replay_concurrency,
                       timeouts=timeouts)
    with faults.fault_scope(faults.FaultPlan.from_json(args.fault_plan)):
        router = await SweepRouter(FileFleet(args.fleet_file),
                                   cfg).start()
        # The serving line is scraped by a role="router" supervisor, as
        # replica lines are; the journal replay already runs in the
        # background (progress through the stats op).
        stats = await _serve_until_drained(
            router, lambda: router._tcp_server is not None,
            {"serving": True, "router": True, "host": cfg.host,
             "port": router.port})
    print(json.dumps({"serving": False, "router": True,
                      "stats": stats}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m pycatkin_tpu_torch.serve",
        description="Run the sweep-as-a-service server, or its front "
                    "router.")
    ap.add_argument("--host", default=None)
    ap.add_argument("--port", type=int, default=None,
                    help="0 binds an ephemeral port (printed)")
    ap.add_argument("--runner", choices=("inproc", "elastic"),
                    default=None)
    ap.add_argument("--work-dir", default=None)
    ap.add_argument("--max-occupancy", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--router", action="store_true",
                    help="run the front router instead of a replica")
    ap.add_argument("--fleet-file", default=None,
                    help="router: endpoints file published by the "
                         "replica supervisor")
    ap.add_argument("--journal-dir", default=None,
                    help="router: write-ahead request journal directory "
                         "(enables durable requests)")
    ap.add_argument("--segment-bytes", type=int, default=None,
                    help="router: journal segment size before rotation")
    ap.add_argument("--replay-concurrency", type=int, default=None,
                    help="router: journaled requests re-dispatched at "
                         "once at boot")
    for cls in ("interactive", "standard", "batch"):
        ap.add_argument(f"--timeout-{cls}", type=float, default=None,
                        help=f"router: end-to-end budget of a {cls} "
                             f"request, seconds")
    ap.add_argument("--fault-plan", default=None,
                    help="router: a fault plan as JSON (chaos drills)")
    args = ap.parse_args(argv)
    if args.router:
        return asyncio.run(_amain_router(args))
    from ..ops.cuda_linalg import KernelError
    try:
        return asyncio.run(_amain(args))
    except KernelError as exc:
        # A replica without its kernels must not serve (and never from
        # the CPU): a nonzero exit, which a supervisor classifies as
        # program-shaped.
        print(f"serve: the CUDA kernel library is unavailable: {exc}",
              file=sys.stderr, flush=True)
        return 3


if __name__ == "__main__":
    sys.exit(main())
