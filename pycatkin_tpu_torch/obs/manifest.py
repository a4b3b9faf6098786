"""The run manifest: a self-describing record of what executed (port of
``pycatkin_tpu/obs/manifest.py``).

One dict answering, machine-readably, "what code, what backend, what
options" for a run; every serve response carries it. Every field is
best-effort: a manifest must never kill the run it describes, so each
probe degrades to None instead of raising.

Schema ``pycatkin-run-manifest/v1``, with the JAX manifest's keys:
``schema``, ``git``, ``backend`` (``platform`` ``"gpu"`` or ``"cpu"``,
``device_count``, ``device_kind`` from ``torch.cuda``), ``mesh`` (when
given), ``env``, ``registered_env_keys``, ``jax_platforms``, ``abi``
(enabled, and the bucket fingerprint when a spec is given),
``aot_key_version``, ``program_budget``, ``cost_ledger``. The port has
no counterpart for several of them and reports None there: it reads no
environment knob (``env``, ``registered_env_keys``, ``jax_platforms``),
compiles no program per shape (``aot_key_version``,
``program_budget``) and keeps no cost ledger (``cost_ledger``). It adds
``torch`` and ``cuda`` (the versions) and ``kernel_library`` (the path
of the built CUDA kernel library, when the manifest is for a CUDA
device).
"""

from __future__ import annotations

import os
import subprocess

SCHEMA = "pycatkin-run-manifest/v1"

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _git_describe():
    try:
        out = subprocess.run(
            ["git", "describe", "--always", "--dirty", "--tags"],
            cwd=_REPO_ROOT, capture_output=True, text=True, timeout=10)
        return out.stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def _device(device):
    import torch
    return torch.device("cuda" if device is None else device)


def _backend_info(device):
    """The device the run is for; never initialises a card the caller
    did not ask for."""
    try:
        import torch
        dev = _device(device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                return None
            idx = dev.index if dev.index is not None \
                else torch.cuda.current_device()
            return {"platform": "gpu",
                    "device_count": torch.cuda.device_count(),
                    "device_kind": torch.cuda.get_device_name(idx)}
        return {"platform": dev.type, "device_count": 1,
                "device_kind": dev.type}
    except Exception:
        return None


def _mesh_info(mesh):
    if mesh is None:
        return None
    try:
        return {"devices": int(mesh.devices.size),
                "axis_names": [str(a) for a in mesh.axis_names],
                "shape": {str(k): int(v)
                          for k, v in dict(mesh.shape).items()}}
    except Exception:
        return None


def _abi_info(spec):
    """The port lowers through ``abi=True`` keywords; the serving path
    always does, so ``enabled`` is True, and ``bucket`` is the
    fingerprint of ``spec``'s bucket when one is given."""
    info = {"enabled": True, "bucket": None}
    try:
        from ..frontend import abi
        if spec is not None:
            low = spec if isinstance(spec, (abi.AbiLowered,
                                            abi.PackedLowered)) \
                else abi.maybe_lower(spec)
            if low is not None:
                info["bucket"] = low.abi_fingerprint
    except Exception:
        pass
    return info


def _versions():
    try:
        import torch
        return torch.__version__, torch.version.cuda
    except Exception:
        return None, None


def _kernel_library(device):
    try:
        if _device(device).type != "cuda":
            return None
        from ..ops import cuda_linalg
        return str(cuda_linalg.library_path())
    except Exception:
        return None


def run_manifest(mesh=None, spec=None, device=None) -> dict:
    """Build the manifest (see the module doc) for a run on ``device``
    (None: the CUDA card, as the entry points resolve it). ``mesh`` and
    ``spec`` are optional context the caller already holds."""
    torch_version, cuda_version = _versions()
    return {
        "schema": SCHEMA,
        "git": _git_describe(),
        "backend": _backend_info(device),
        "mesh": _mesh_info(mesh),
        "env": None,
        "registered_env_keys": None,
        "jax_platforms": None,
        "abi": _abi_info(spec),
        "aot_key_version": None,
        "program_budget": None,
        "cost_ledger": None,
        "torch": torch_version,
        "cuda": cuda_version,
        "kernel_library": _kernel_library(device),
    }
