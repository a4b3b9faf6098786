"""The PyTorch port stands alone: no module of ``pycatkin_tpu_torch`` and
no line of ``chip_smoke.py`` imports JAX or the JAX package, importing
the port loads neither, and its entry points never drop to the CPU
unasked."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "pycatkin_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "pycatkin_tpu")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, files in os.walk(PKG):
        out += [os.path.join(base, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_jax_package_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


def test_port_has_modules_to_scan():
    names = {os.path.relpath(p, ROOT) for p in _port_files()}
    assert "pycatkin_tpu_torch/ops/cuda_linalg.py" in names
    assert "pycatkin_tpu_torch/parallel/batch.py" in names
    for mod in ("durable", "router", "fleet"):
        assert f"pycatkin_tpu_torch/serve/{mod}.py" in names


def test_import_loads_neither_jax_nor_the_jax_package():
    mods = ["pycatkin_tpu_torch"] + [
        "pycatkin_tpu_torch." + os.path.relpath(p, PKG)[:-3].replace(
            os.sep, ".").replace(".__init__", "")
        for p in _port_files() if p.startswith(PKG)]
    code = ("import importlib, sys\n"
            f"for m in {sorted(set(mods))!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "print(len(bad), bad[:5])\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("0 "), out.stdout


def test_port_imports_without_pandas_and_matplotlib():
    """Every module of the port imports with pandas and matplotlib
    blocked, as on a card machine that has neither: the presets write
    their CSV files with the csv module, the plots import matplotlib
    when called."""
    mods = ["pycatkin_tpu_torch"] + [
        "pycatkin_tpu_torch." + os.path.relpath(p, PKG)[:-3].replace(
            os.sep, ".").replace(".__init__", "")
        for p in _port_files() if p.startswith(PKG)]
    code = ("import importlib, sys\n"
            "sys.modules['pandas'] = None\n"
            "sys.modules['matplotlib'] = None\n"
            f"for m in {sorted(set(mods))!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_system_without_cuda_raises_when_it_computes(monkeypatch):
    """``System(device=None)`` builds without a card and raises when a
    computation would need one; ``device="cpu"`` runs."""
    from pycatkin_tpu_torch.models.synthetic import synthetic_system

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sim = synthetic_system(10, 5, seed=0)
    assert sim.spec.n_reactions == 5
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sim.rate_constant_table()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sim.find_steady(use_transient_guess=False)
    sim.device_request = "cpu"
    assert sim.rate_constant_table()[0].shape == (5,)


def test_fused_sweep_without_cuda_raises_and_runs_nothing(monkeypatch):
    from pycatkin_tpu_torch.models.synthetic import synthetic_spec
    from pycatkin_tpu_torch.ops import cuda_linalg
    from pycatkin_tpu_torch.parallel import batch
    from pycatkin_tpu_torch.solvers import newton

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec, base = synthetic_spec(12, 14, seed=0)
    conds = batch.broadcast_conditions(base, 2)
    newton.reset_syncs()
    cuda_linalg.reset_launches()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch.fused_sweep(spec, conds, device=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch.resolve_device("cuda")
    assert newton.SYNCS["ptc_active"] == 0
    assert set(cuda_linalg.LAUNCHES.values()) == {0}
    assert batch.resolve_device("cpu") == torch.device("cpu")


def test_broadcast_conditions_are_float64_with_a_lane_axis():
    from pycatkin_tpu_torch import engine
    from pycatkin_tpu_torch.models.synthetic import synthetic_spec
    from pycatkin_tpu_torch.parallel import batch

    spec, base = synthetic_spec(12, 14, seed=0)
    conds = batch.broadcast_conditions(base, 3)
    assert conds.T.shape == (3,) and conds.gelec.shape == (
        3, spec.n_species)
    dev = engine.conditions_to(conds, "cpu")
    assert all(t.dtype == torch.float64 for t in dev)
    np.testing.assert_array_equal(dev.y0[1].numpy(), base.y0)
