"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``pycatkin_tpu_torch/csrc`` and runs:

1. device: the card's name and power limit (nvidia-smi) and the build time;
2. kernel check: every kernel (``lu_factor``, ``lu_solve``,
   ``factor_solve``) against its plain PyTorch version on the card, at
   n = 16, 21, 32, 64, 128 with well-conditioned lanes plus one singular
   lane (perm equal, LU and x within 1e-12 relative, the singular lane
   non-finite), then each kernel timed at the shapes the sweep gives it
   beside its plain version and the matching ``torch.linalg`` call;
3. main path: ``fused_sweep`` on the flagship synthetic 24-species /
   32-reaction mechanism, 65,536 lanes with T from 400 to 800 K, launch
   counters zeroed just before and read just after; then 256 of those
   lanes re-run on the CPU through the plain versions (verdicts equal,
   states within rtol 1e-5 / atol 1e-12);
4. certificate path: ``fused_sweep`` on the synthetic (12, 14) seed-0
   mechanism (deflated dimension 8: a 64 x 64 Kronecker solve per lane),
   4,096 lanes, which must launch ``factor_solve``;
5. where the time goes: the main path re-run warm, then once more under
   torch.profiler (device-busy share and the top device kernels).

It prints one line per phase, a ``{"kernels": [...]}`` JSON line, the
nvidia-smi line, and last ``{"ok": true, "device": {...}}``. The
kernels line has one row per kernel per path (``path`` is ``flagship``
or ``certificate``): its ``launches`` are that path's own run's, and its
times are taken at the shapes that path gives the kernel. Any failure
raises and exits non-zero; without a CUDA card it exits 1 and prints no
result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# FP64 peak of one H100 SXM (NVIDIA data sheet: 67 TFLOP/s on the FP64
# tensor cores, 34 TFLOP/s on the FP64 vector units) and its HBM3 rate.
PEAK_FP64_FLOPS = 67.0e12
PEAK_BYTES_PER_S = 3.35e12
SIZES = (16, 21, 32, 64, 128)
KERNEL_TOL = 1e-12
FLAGSHIP_LANES = 65536   # bench.py's default 256 x 256 grid
CERT_LANES = 4096
CHECK_LANES = 4096       # well-conditioned lanes per kernel check size
SUBSET = 256             # flagship lanes re-run on the CPU
REPS = 20                # timed calls per kernel


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls
    (CUDA events, after ``warmup`` calls)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def lu_flops(n: int) -> float:
    """FP64 operations of one partial-pivoted LU: per step one division
    and one multiply-subtract per trailing entry."""
    return float(sum(m + 2 * m * m for m in range(1, n)))


def solve_flops(n: int, k: int = 1) -> float:
    """FP64 operations of the two triangular passes for k right-hand
    sides."""
    return float(k * (2 * n * n - n))


def bound(bytes_moved: float, flops: float):
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP64_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def test_matrices(lanes: int, n: int, seed: int, device):
    """``lanes`` diagonally dominant (well-conditioned) row-shuffled
    systems plus one singular lane (a zero column) at the end."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((lanes + 1, n, n))
    A += 2.0 * n * np.eye(n)
    for i in range(0, lanes, 7):
        A[i] = A[i][rng.permutation(n)]
    A[-1, :, n // 2] = 0.0
    b = rng.standard_normal((lanes + 1, n))
    t = lambda a: torch.tensor(a, dtype=torch.float64, device=device)
    return t(A), t(b)


def rel_err(a, b) -> float:
    import torch
    return float(torch.max(torch.abs(a - b)) / torch.max(torch.abs(b)))


def check_kernels(cl, lanes: int, device) -> None:
    """Phase 2a: each kernel against its plain version at every size."""
    import torch
    for n in SIZES:
        A, b = test_matrices(lanes, n, seed=n, device=device)
        B = b[:, :, None].repeat(1, 1, 4).contiguous()
        LU, perm = cl.lu_factor(A)
        torch.cuda.synchronize()
        LUr, permr = cl.lu_factor_ref(A)
        good = slice(0, lanes)
        assert torch.equal(perm[good], permr[good]), f"lu_factor n={n}: perm"
        e_lu = rel_err(LU[good], LUr[good])
        assert e_lu <= KERNEL_TOL, f"lu_factor n={n}: LU rel err {e_lu}"
        errs = {}
        for name, rhs in (("vec", b), ("mat", B)):
            x = cl.lu_solve(LU, perm, rhs)
            torch.cuda.synchronize()
            xr = cl.lu_solve_ref(LUr, permr, rhs)
            xf = cl.factor_solve(A, rhs)
            torch.cuda.synchronize()
            xfr = cl.factor_solve_ref(A, rhs)
            e1, e2 = rel_err(x[good], xr[good]), rel_err(xf[good], xfr[good])
            assert e1 <= KERNEL_TOL, f"lu_solve n={n} {name}: {e1}"
            assert e2 <= KERNEL_TOL, f"factor_solve n={n} {name}: {e2}"
            for out in (x, xf):
                assert not bool(torch.isfinite(out[-1]).all()), \
                    f"n={n} {name}: singular lane came out finite"
                assert bool(torch.isfinite(out[good]).all()), \
                    f"n={n} {name}: a well-conditioned lane is non-finite"
            errs[name] = max(e1, e2)
        assert not bool(torch.isfinite(LU[-1]).all())
        log(f"kernel check n={n}: {lanes}+1 lanes, perm equal, LU rel err "
            f"{e_lu:.2e}, x rel err vec {errs['vec']:.2e} mat "
            f"{errs['mat']:.2e}, singular lane non-finite")


def time_lu(cl, n: int, L: int, device) -> list:
    """Phase 2b: ``lu_factor`` and ``lu_solve`` at ``L`` lanes of size
    ``n`` (the last lane singular) beside their plain versions and the
    matching torch.linalg calls; returns one row each."""
    import torch
    A, b = test_matrices(L - 1, n, seed=n, device=device)
    LU, perm = cl.lu_factor(A)
    LUr, permr = cl.lu_factor_ref(A)
    lu_err = float(torch.max(torch.abs(LU[:-1] - LUr[:-1])))
    assert torch.equal(perm[:-1], permr[:-1])
    ms = cuda_ms(lambda: cl.lu_factor(A), REPS)
    plain = cuda_ms(lambda: cl.lu_factor_ref(A), 2)
    lib = cuda_ms(lambda: torch.linalg.lu_factor_ex(A), REPS)
    bms, by = bound(L * (2 * n * n * 8 + n * 4), L * lu_flops(n))
    rows = [dict(name="lu_factor", n=n, lanes=L, max_abs_err=lu_err, ms=ms,
                 plain_ms=plain, bound_ms=bms, bound_by=by,
                 library_ms=lib)]

    x = cl.lu_solve(LU, perm, b)
    xr = cl.lu_solve_ref(LUr, permr, b)
    sol_err = float(torch.max(torch.abs(x[:-1] - xr[:-1])))
    tLU, tpiv, _ = torch.linalg.lu_factor_ex(A)
    ms = cuda_ms(lambda: cl.lu_solve(LU, perm, b), REPS)
    plain = cuda_ms(lambda: cl.lu_solve_ref(LU, perm, b), 2)
    lib = cuda_ms(lambda: torch.linalg.lu_solve(tLU, tpiv, b[:, :, None]),
                  REPS)
    bms, by = bound(L * (n * n * 8 + n * 4 + 2 * n * 8),
                    L * solve_flops(n))
    rows.append(dict(name="lu_solve", n=n, lanes=L, max_abs_err=sol_err,
                     ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                     library_ms=lib))
    return rows


def time_factor_solve(cl, n: int, L: int, device) -> dict:
    """Phase 2b: ``factor_solve`` at ``L`` lanes of size ``n`` beside its
    plain version and ``torch.linalg.solve_ex``; returns its row."""
    import torch
    A, b = test_matrices(L - 1, n, seed=2, device=device)
    xf = cl.factor_solve(A, b)
    xfr = cl.factor_solve_ref(A, b)
    fs_err = float(torch.max(torch.abs(xf[:-1] - xfr[:-1])))
    ms = cuda_ms(lambda: cl.factor_solve(A, b), REPS)
    plain = cuda_ms(lambda: cl.factor_solve_ref(A, b), 2)
    lib = cuda_ms(lambda: torch.linalg.solve_ex(A, b), REPS)
    bms, by = bound(L * (n * n * 8 + 2 * n * 8),
                    L * (lu_flops(n) + solve_flops(n)))
    return dict(name="factor_solve", n=n, lanes=L, max_abs_err=fs_err,
                ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                library_ms=lib)


def sweep(spec, conds, mask, device):
    """One fused sweep with the launch counters and sync counter zeroed
    just before and read just after; returns (outputs, counts, syncs,
    wall seconds)."""
    import torch
    from pycatkin_tpu_torch.ops import cuda_linalg as cl
    from pycatkin_tpu_torch.parallel import batch
    from pycatkin_tpu_torch.solvers import newton
    torch.cuda.synchronize()
    cl.reset_launches()
    newton.reset_syncs()
    t0 = time.perf_counter()
    out = batch.fused_sweep(spec, conds, mask, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(cl.LAUNCHES)
    syncs = newton.SYNCS["ptc_active"]
    return out, counts, syncs, wall


def profile_main_path(spec, conds, mask, device) -> None:
    """Phase 5: a warm re-run of the main path, then one under
    torch.profiler: warm wall, device-busy share and the top device
    kernels by time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    _, counts, syncs, wall = sweep(spec, conds, mask, device)
    log(f"phase 5 warm main path: wall {wall:.3f} s, "
        f"{len(conds.T) / wall:.1f} lanes/s, host syncs {syncs}, "
        f"launches {counts}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, _, pwall = sweep(spec, conds, mask, device)
    # Device time = the kernels' and copies' own intervals on the card
    # (events of device type CUDA; operator rows would count them twice).
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e6
    by_name: dict = {}
    for e in kernels:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    log(f"phase 5 profile: wall under the profiler {pwall:.3f} s, device "
        f"busy {busy:.3f} s ({100.0 * busy / pwall:.1f} % of wall), "
        f"{len(kernels)} device kernels and copies")
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[
            :15]:
        log(f"phase 5 kernel {name[:70]!r}: {t / 1e3:.1f} ms, {c} calls, "
            f"{100.0 * t / 1e6 / busy:.1f} % of device time")


def verdicts(out):
    res, quar, cert, amb, tofs, act, neg = out[:7]
    return {"success": res.success, "quarantined": quar, "certified": cert,
            "ambiguous": amb, "negative_tof": neg}


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from pycatkin_tpu_torch import engine
    from pycatkin_tpu_torch.models.synthetic import synthetic_spec
    from pycatkin_tpu_torch.ops import cuda_linalg as cl
    from pycatkin_tpu_torch.parallel import batch
    from pycatkin_tpu_torch.solvers.newton import deflation_basis_for_spec

    device = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    cl.build(verbose=True)
    log(f"phase 1 device: {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | kernels built in "
        f"{time.perf_counter() - t0:.2f} s")

    # -- phase 2: kernels against their plain versions -----------------
    check_kernels(cl, CHECK_LANES, device)
    log("phase 2 kernel check: all sizes passed")

    # -- phase 3: the main path ----------------------------------------
    spec, base = synthetic_spec(24, 32, seed=0)
    L = FLAGSHIP_LANES
    conds = batch.broadcast_conditions(base, L)._replace(
        T=np.linspace(400.0, 800.0, L))
    mask = engine.tof_mask_for(spec, [spec.rnames[-1]])
    torch.cuda.reset_peak_memory_stats()
    out, counts, syncs, wall = sweep(spec, conds, mask, device)
    peak = torch.cuda.max_memory_allocated() / 2**20
    res = out[0]
    v = verdicts(out)
    n_dyn = len(spec.dynamic_indices)
    bundle = out[-1].cpu().tolist()
    log(f"phase 3 main path: flagship synthetic(24, 32) n_dyn={n_dyn}, "
        f"{L} lanes T 400-800 K | converged "
        f"{int(v['success'].sum())} quarantined "
        f"{int(v['quarantined'].sum())} certified "
        f"{int(v['certified'].sum())} ambiguous "
        f"{int(v['ambiguous'].sum())} negative-TOF "
        f"{int(v['negative_tof'].sum())} | bundle {bundle} | median "
        f"iterations {float(res.iterations.float().median()):.0f} max "
        f"{int(res.iterations.max())} | host syncs {syncs} | wall "
        f"{wall:.3f} s, {L / wall:.1f} lanes/s, peak memory {peak:.1f} MiB "
        f"| launches {counts}")
    assert counts["lu_factor"] > 0 and counts["lu_solve"] > 0, counts
    assert res.x.shape == (L, spec.n_species)
    ok = v["success"]
    assert bool(torch.isfinite(res.x[ok]).all())
    assert bool(torch.isfinite(out[5][ok & v["certified"]]).all())

    # CPU parity on a subset, through the plain versions.
    idx = np.linspace(0, L - 1, SUBSET).round().astype(np.int64)
    sub = type(conds)(*(np.asarray(f)[idx] for f in conds))
    out_cpu = batch.fused_sweep(spec, sub, mask, device="cpu")
    vc = verdicts(out_cpu)
    for name in v:
        assert torch.equal(v[name][idx].cpu(), vc[name]), \
            f"CPU subset parity: {name} differs"
    x_gpu, x_cpu = res.x[idx].cpu(), out_cpu[0].x
    close = torch.allclose(x_gpu, x_cpu, rtol=1e-5, atol=1e-12)
    dx = float(torch.max(torch.abs(x_gpu - x_cpu)))
    assert close, f"CPU subset parity: states differ by {dx}"
    log(f"phase 3 CPU parity: {SUBSET} lanes re-run on the CPU through "
        f"the plain versions: verdicts equal, max |dx| {dx:.3e} "
        f"(rtol 1e-5, atol 1e-12)")

    # -- phase 4: the certificate path ---------------------------------
    cspec, cbase = synthetic_spec(12, 14, seed=0)
    Lc = CERT_LANES
    cconds = batch.broadcast_conditions(cbase, Lc)._replace(
        T=np.linspace(400.0, 800.0, Lc))
    cmask = engine.tof_mask_for(cspec, [cspec.rnames[-1]])
    cout, ccounts, csyncs, cwall = sweep(cspec, cconds, cmask, device)
    cv = verdicts(cout)
    log(f"phase 4 certificate path: synthetic(12, 14) seed 0, {Lc} lanes | "
        f"converged {int(cv['success'].sum())} certified "
        f"{int(cv['certified'].sum())} ambiguous "
        f"{int(cv['ambiguous'].sum())} | host syncs {csyncs} | wall "
        f"{cwall:.3f} s | launches {ccounts}")
    assert all(ccounts[k] > 0 for k in ccounts), ccounts

    # -- phase 5: where the main path's time goes -------------------------
    profile_main_path(spec, conds, mask, device)

    # -- kernels line: one row per kernel per path ------------------------
    m = deflation_basis_for_spec(cspec).shape[1]
    assert 1 <= m <= 8, m
    n_cert_dyn = len(cspec.dynamic_indices)
    timed = [("flagship", counts, r) for r in time_lu(cl, n_dyn, L, device)]
    timed += [("certificate", ccounts, r)
              for r in time_lu(cl, n_cert_dyn, Lc, device)
              + [time_factor_solve(cl, m * m, Lc, device)]]
    replaces = {
        "lu_factor": "pycatkin_tpu/ops/pallas_linalg.py:204",
        "lu_solve": "pycatkin_tpu/ops/pallas_linalg.py:219",
        "factor_solve": "pycatkin_tpu/ops/pallas_linalg.py:233",
    }
    kernels = []
    for path, path_counts, r in timed:
        kernels.append(dict(
            name=r["name"], route="cuda",
            source="pycatkin_tpu_torch/csrc/linalg.cu",
            replaces=replaces[r["name"]], launches=path_counts[r["name"]],
            max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            path=path, n=r["n"], lanes=r["lanes"]))
        log(f"timing {r['name']} ({path}, {path_counts[r['name']]} "
            f"launches): n={r['n']} x {r['lanes']} lanes | kernel "
            f"{r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms torch.linalg "
            f"{r['library_ms']:.4f} ms bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
