"""Sweep-as-a-service on the card (port of ``pycatkin_tpu/serve``): a
single-process asyncio server speaking the ``pycatkin-serve/v1``
JSON-lines protocol over TCP (plus an in-process :class:`SweepClient`)
that admits mechanism + conditions-grid requests, coalesces same-bucket
tenants into packed runs with SLA-aware flushing, and answers every
request with its run manifest, per-lane telemetry and quarantine
report. ``python -m pycatkin_tpu_torch.serve`` runs one.

Above the single server sits the fleet tier: a
:class:`ReplicaSupervisor` (:mod:`.fleet`) keeping N server replicas
alive, each on the card with its kernel library loaded before it
serves, and a :class:`SweepRouter` (:mod:`.router`) multiplexing
clients across them with circuit breakers, SLA-budgeted retries, hedged
interactive dispatch and loss-free failover
(``python -m pycatkin_tpu_torch.serve --router``). A
:class:`RequestJournal` (:mod:`.durable`) write-ahead-logs every keyed
request before it is acknowledged, so a killed router -- restarted by a
``FleetConfig(role="router")`` supervisor and re-reading the replica
endpoints through :class:`FileFleet` -- replays its
accepted-but-unanswered backlog and serves bitwise-identical journaled
answers for duplicate idempotency keys.
"""

from .client import SweepClient, TcpSweepClient
from .durable import RequestJournal
from .fleet import FileFleet, FleetConfig, ReplicaSupervisor
from .protocol import (DEADLINE_CLASSES, ServeConfig, ServeError,
                       error_response)
from .router import RouterConfig, SweepRouter
from .server import SweepServer

__all__ = ["SweepServer", "SweepClient", "TcpSweepClient",
           "ServeConfig", "ServeError", "DEADLINE_CLASSES",
           "error_response", "ReplicaSupervisor", "FleetConfig",
           "SweepRouter", "RouterConfig", "RequestJournal",
           "FileFleet"]
