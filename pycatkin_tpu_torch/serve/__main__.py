"""``python -m pycatkin_tpu_torch.serve`` -- run a sweep server until
drained (SIGINT / SIGTERM trigger the graceful drain).

    python -m pycatkin_tpu_torch.serve [--host H] [--port P]
        [--runner inproc|elastic] [--work-dir D] [--max-occupancy K]
        [--device cuda|cpu]

The bound port is printed as a JSON line on stdout so a supervisor can
scrape it; a second JSON line with the server's stats follows the drain.
``--device`` defaults to the CUDA card (and the server refuses to start
without one). ``--runner elastic`` runs solo groups through the elastic
scheduler's worker processes. ``--router`` (the JAX package's front router) is not
ported and raises.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import signal
import sys


async def _amain(args) -> int:
    from .protocol import ServeConfig
    from .server import SweepServer

    cfg = ServeConfig(host=args.host, port=args.port, runner=args.runner,
                      work_dir=args.work_dir,
                      max_occupancy=args.max_occupancy, device=args.device)
    server = await SweepServer(cfg).start()
    print(json.dumps({"serving": True, "host": cfg.host,
                      "port": server.port}), flush=True)

    loop = asyncio.get_running_loop()
    draining = asyncio.Event()

    def _trigger_drain():
        if not draining.is_set():
            draining.set()
            loop.create_task(server.drain())

    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            loop.add_signal_handler(sig, _trigger_drain)
        except (NotImplementedError, OSError):
            pass
    # Serve until something (a signal, or a client "drain" op) drains
    # the server and its scheduler loop exits.
    while server._scheduler_task is not None:
        await asyncio.sleep(0.1)
    print(json.dumps({"serving": False,
                      "stats": server.stats()}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m pycatkin_tpu_torch.serve",
        description="Run the sweep-as-a-service server.")
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
                    help="the front router: not ported")
    args = ap.parse_args(argv)
    if args.router:
        raise NotImplementedError(
            "--router: the front router, the replica fleet and the "
            "request journal are not ported yet (ROADMAP.md Queue A)")
    return asyncio.run(_amain(args))


if __name__ == "__main__":
    sys.exit(main())
