"""Sweep-as-a-service on the card (port of the single-server parts of
``pycatkin_tpu/serve``): a single-process asyncio server speaking the
``pycatkin-serve/v1`` JSON-lines protocol over TCP (plus an in-process
:class:`SweepClient`) that admits mechanism + conditions-grid requests,
coalesces same-bucket tenants into packed runs with SLA-aware flushing,
and answers every request with its run manifest, per-lane telemetry and
quarantine report. ``python -m pycatkin_tpu_torch.serve`` runs one.

The fleet tier (replica supervisor, front router) and the durable
request journal are not ported yet (ROADMAP.md Queue A).
"""

from .client import SweepClient, TcpSweepClient
from .protocol import (DEADLINE_CLASSES, ServeConfig, ServeError,
                       error_response)
from .server import SweepServer

__all__ = ["SweepServer", "SweepClient", "TcpSweepClient",
           "ServeConfig", "ServeError", "DEADLINE_CLASSES",
           "error_response"]
