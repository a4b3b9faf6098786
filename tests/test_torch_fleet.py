"""The port's fleet tier with real replicas: the chaos drill and the
durable smoke of ``pycatkin_tpu_torch.serve.soak`` on the CPU, and the
replica's refusal to serve without its device or its kernels.

- The mini drill: two replica processes
  (``python -m pycatkin_tpu_torch.serve --device cpu``) behind a
  journal-backed router process, bucket 32 (the smallest bucket whose
  sweeps reach the LU kernels' wrappers), 8 requests of 2 lanes; one
  replica and the router are killed mid-stream, and
  :func:`check_chaos_record` must find nothing: no request lost, every
  answer and every journaled answer bitwise the in-process baseline's,
  the killed replica and the router back. Under its own time limit.
- The durable smoke (journal round trip, router-kill replay over a stub
  replica) passes :func:`check_durable_record`.
- A replica asked for the card on a machine without one refuses to
  start, and its supervisor abandons it as a program-shaped exit; on a
  card (marker ``cuda``) a replica whose kernel library cannot be built
  or loaded exits nonzero before it serves.
"""

import os
import subprocess
import sys

import pytest

from pycatkin_tpu_torch.serve.fleet import FleetConfig, ReplicaSupervisor
from pycatkin_tpu_torch.serve.soak import (check_chaos_record,
                                           check_durable_record,
                                           run_chaos_drill,
                                           run_durable_smoke)
from torch_serve_stubs import run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_chaos_drill_on_the_cpu_loses_nothing():
    record = run_chaos_drill(device="cpu", bucket=32, n_requests=8,
                             lanes=2, n_replicas=2, kill=1,
                             router_crash=True, time_limit_s=150.0)
    assert check_chaos_record(record) == []
    assert record["incarnations"][0] >= 2
    assert record["durable"]["router_incarnations"] >= 2
    assert record["durable"]["client_acks"] >= record["n_requests"]
    # Every replica answered from the CPU with no kernel library.
    assert all(st["flushes"] and not st["flushes_with_compiles"]
               for st in record["replica_stats"].values())
    # On the CPU the wrappers run their plain versions: no launch counted.
    assert record["launches"] == {"baseline": [], "replicas": []}


def test_durable_smoke_passes():
    assert check_durable_record(run_durable_smoke()) == []


def test_replica_without_a_card_refuses_and_is_abandoned():
    # No CUDA device visible, on any machine: a replica asked for the
    # card (the default) must not fall back to the CPU.
    env = {"CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run(
        [sys.executable, "-m", "pycatkin_tpu_torch.serve", "--port", "0"],
        cwd=REPO, env=dict(os.environ, **env), capture_output=True,
        text=True, timeout=120)
    assert out.returncode != 0
    assert "serving" not in out.stdout
    assert "no CUDA device" in out.stderr

    async def scenario():
        sup = ReplicaSupervisor(FleetConfig(
            n_replicas=1, env=env, max_restarts=1,
            restart_base_delay_s=0.01, restart_max_delay_s=0.02,
            boot_timeout_s=60.0, tick_s=0.01))
        with pytest.raises(RuntimeError, match="no replica came up"):
            await sup.start()
        try:
            rep = sup.replicas[0]
            assert rep.state == "abandoned"
            assert rep.last_exit_kind == "nonzero-exit"
            assert rep.incarnation == 2
        finally:
            await sup.stop()
    run(scenario(), limit_s=120.0)


# A replica on the card whose kernel library cannot be built: an empty
# build directory and no nvcc to be found.
NO_KERNELS = """
import os, sys, tempfile
from pathlib import Path
from pycatkin_tpu_torch.ops import cuda_linalg
cuda_linalg.BUILD_DIR = Path(tempfile.mkdtemp())
os.environ["PATH"] = os.path.dirname(sys.executable)
os.environ["CUDA_HOME"] = tempfile.mkdtemp()
from pycatkin_tpu_torch.serve.__main__ import main
sys.exit(main(["--device", "cuda", "--port", "0"]))
"""


@pytest.mark.cuda
def test_replica_on_the_card_without_its_kernels_exits_nonzero(tmp_path):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    script = tmp_path / "no_kernels.py"
    script.write_text(NO_KERNELS)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    out = subprocess.run([sys.executable, str(script)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 3, out.stderr
    assert "serving" not in out.stdout
    assert "kernel library is unavailable" in out.stderr

    async def scenario():
        sup = ReplicaSupervisor(FleetConfig(
            n_replicas=1, command=[sys.executable, str(script)],
            max_restarts=1, restart_base_delay_s=0.01,
            restart_max_delay_s=0.02, boot_timeout_s=120.0, tick_s=0.01))
        with pytest.raises(RuntimeError, match="no replica came up"):
            await sup.start()
        try:
            assert sup.replicas[0].state == "abandoned"
            assert sup.replicas[0].last_exit_kind == "nonzero-exit"
        finally:
            await sup.stop()
    run(scenario(), limit_s=300.0)
