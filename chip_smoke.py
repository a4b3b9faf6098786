"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``pycatkin_tpu_torch/csrc`` and runs:

1. device: the card's name and power limit (nvidia-smi) and the build
   time; TF32 must be off for float32 matrix products (the f32 bulk
   march's ``net @ stoich.T`` runs in full float32);
2. kernel check: every kernel (``lu_factor``, ``lu_solve``,
   ``factor_solve``), in float64 and in float32 (``*_f32``, x within
   1e-12 eps32 / eps64 there), against its plain PyTorch version in the
   same type on the card, at
   n = 16, 32 (the warp tier), 9, 21, 54 (the unpadded transient's stage
   matrices), 64 (the resident tier, the matrix
   in shared memory, three or more lanes an SM), 112 (the resident tier
   with two lanes an SM, on 256 threads), 128, 165 (the panel tier, the
   matrix in device memory, where one lane alone fits an SM's shared
   memory), 170, 200,
   256, 512 (the panel tier; 170 is the first n whose lane does not fit
   at k = 1, 200 leaves a last panel of 8 columns), with
   well-conditioned lanes plus one singular lane: perm and LU equal to
   the plain version's (``torch.equal``), x within 1e-12 relative,
   ``lu_solve(*lu_factor(A), b)`` equal to ``factor_solve(A, b)``
   (``torch.equal``: both take each entry's updates in the same order),
   the singular lane non-finite. At n = 16 and 32 the check takes 65,537
   lanes, which leaves the warp tier a partial last block. Then the
   plain-PyTorch Gauss-Jordan route (n = 8, 21) on the card against the
   CPU, and the threefry keys and uniform draws of the rescue ladder's
   restarts (``ops/prng.py``) bit for bit against the CPU's;
3. flagship path: ``fused_sweep`` on the synthetic 24-species /
   32-reaction mechanism, 65,536 lanes with T from 400 to 800 K. Its
   n = 21 direction solves take Gauss-Jordan, as in the JAX package, so
   it must launch no kernel. 256 of its lanes re-run on the CPU must
   give the same verdicts. The Gauss-Jordan route moves states ~1e-4
   under a one-ulp change of its inputs, in the JAX package as here, so
   the CPU lanes also run with T up, T down and kscale up by one ulp:
   the card's states, TOF and activity must lie within twice the largest
   of those spreads, and the card's states must pass the solver's
   convergence test evaluated on the CPU (normalized residual <= 1,
   plus the 1e-3 that two evaluations of it may differ by);
4. certificate path: ``fused_sweep`` on the synthetic (12, 14) seed-0
   mechanism (deflated dimension 8: a 64 x 64 Kronecker solve per lane),
   4,096 lanes, which must launch ``factor_solve``;
5. ABI flagship path: ``sweep_steady_state(..., abi=True,
   check_stability=True)`` on the flagship mechanism lowered into its
   bucket (S = 128, R = 64, D = 32), 65,536 lanes, T 400-800 K: the
   direction solves take ``lu_factor`` + ``lu_solve`` at n = 32 and the
   padded certificate ``factor_solve`` at n = 16;
6. ABI certificate path: the same on synthetic (10, 5) seed 0 (the JAX
   package's bucket-16 mechanism; D = 8, deflated dimension 4, so the
   16 x 16 Lyapunov system decides), 65,536 lanes, which must launch
   ``factor_solve``;
   paths 4-6 re-run 256 lanes on the CPU through the plain versions:
   verdicts equal, states within rtol 1e-5 / atol 1e-12;
7. large path: synthetic (200, 200) seed 0, 2,048 lanes, T 400-800 K,
   run two ways, each of which must launch ``lu_factor`` and
   ``lu_solve``: ``fused_sweep`` (n_dyn = 165 > 128, the LU route, the
   panel tier) and ``sweep_steady_state(abi=True,
   check_stability=False)`` (S = 512, D = 256, the LU route on the
   panel tier). The tier-2 host eigensolve at n = 256 is left
   out: it is host time this phase does not measure. 16 lanes of each
   re-run on the CPU (in worker processes started with the script):
   verdicts equal; states, TOF and activity within
   rtol 1e-5 / atol 1e-9 (:data:`LARGE_ENVELOPE`), and the card's
   states pass the CPU's convergence test. The log line also gives the
   reference's own spread under a one-ulp change of T or kscale, which
   is why the atol is not phase 5's 1e-12;
8. where the time goes: the ABI flagship and both large runs re-run
   warm, then once more under torch.profiler (device-busy share and the
   top device kernels); the flagship re-run warm; one Gauss-Jordan solve
   (``gauss_solve``, the flagship's direction solve) timed at the
   flagship's shape;
9. each kernel timed at the shapes each path gives it, beside its plain
   version, the matching ``torch.linalg`` call, its bound and the FP64
   vector floor (see :func:`vector_floor_ms`), and the wrapper's host
   time per launch (checks, output allocation, the C entry's choice of
   tier and plan, the launch), the float32 builds at phase 14's and 15's
   path shapes with 4-byte bounds and the FP32 vector floor; then, on
   no path, the three kernels at n = 512 and ``factor_solve`` at n = 256
   (phase 13b gives n = 165 its path), in both types, and
   ``factor_solve_f32`` at the float64 paths' shapes;
10. rescue path: ``sweep_steady_state(..., opts=SolverOptions(max_steps=6,
   max_attempts=3), abi=True, check_stability=True)`` on the ABI
   flagship, 65,536 lanes, T 400-800 K: the 6-step cap (the JAX
   package's failure corpus) fails lanes in the first pass, so they go
   through the rescue ladder; it prints the lanes entering and leaving
   each rung, the strategy codes, attempts, iterations, walls first and
   warm, and must launch all three kernels. Then the LM rung alone
   (``_rescue(..., "lm")``) on the first pass's failed lanes at full
   width, and its program on the first 256 of them on the card and on
   the CPU (counts and verdict tests equal). The first 256 lanes (a
   prefix, so that each failed lane's rescue key is the same) run
   through the whole ladder on the CPU: success, quarantined, stable,
   attempts and strategy codes equal, states, TOF and activity within
   rtol 1e-5 / atol 1e-12 (else within the one-ulp gate of phase 3);
   256 rescued lanes must pass the convergence test on the CPU;
11. the flagship entry as written (``__graft_entry__.py``): per lane
   ``engine.steady_state`` with the default ``SolverOptions()`` (five
   attempts) and key i of ``split(prng_key(0), L)``, then ``tof`` and
   ``activity_from_tof(|tof|)``, on the unpadded flagship, 65,536 lanes,
   T 450-650 K; walls, the attempt histogram, and 256 lanes held to the
   CPU through phase 3's one-ulp gate;
12. the transient: ``batch_transient`` on the flagship mechanism, T
   400-800 K, save grid 0 then 1e-10 .. 1e8 s, three paths
   (:data:`TRANSIENT_PATHS`): TR-BDF2 unpadded (stage matrices n = 54,
   ``lu_factor`` resident tier and tiled ``lu_solve``), TR-BDF2 with
   ``abi=True`` (n = 128: panel-tier ``lu_factor``, tiled ``lu_solve``)
   and ESDIRK4 with ``abi=True``; each once (none takes at most
   :data:`WARM_RERUN_MAX_S`, under which a path is re-run warm with the
   same launches and host syncs; phase 17c re-runs ESDIRK4 on the
   chunked route and asserts phase 12's launches), with walls,
   lanes/s, save points/s, peak memory, host syncs, lane-steps accepted,
   rejected and ended steady, ``ok``, the lanes the Newton finish took
   and rescued, the quarantine count and the launches, then a profile of
   the first steps of its first save interval (per step: wall, device
   busy time, device kernels; the unpadded path also at 512 lanes), run
   twice with the same launches, host syncs and states, bit for bit. 16
   lanes of each
   re-run on the CPU (:data:`TRANSIENT_SUBSET`; the CPU's time there is
   the slowest lane's step count, not the lane count) in worker
   processes started with the script: ``ok`` and the diagnostics
   (failed and quarantined lanes) equal, ``ys`` within rtol 1e-5 / atol
   1e-12; a lane outside that re-runs in a worker with T up, T down and
   kscale up by one ulp, and must lie within twice their spread, by
   :data:`TRANSIENT_GATE_BY` seconds after the start;
13. degree of rate control (``engine.drc`` / ``engine.drc_fd``, the
   TOF of the last reaction, from the states of the path's own sweep, as
   ``presets._sweep`` passes them): 13a the implicit adjoint on the
   flagship's 65,536 lanes from phase 3's states (n = 21, Gauss-Jordan:
   no kernel may launch); 13b the implicit adjoint on the large
   mechanism's 2,048 lanes from phase 7's states, which must launch
   ``factor_solve`` at n = 165 exactly three times (two polish steps and
   the adjoint solve) beside the steady solve's ``lu_factor`` /
   ``lu_solve``; 13c finite differences on 1,024 of the flagship's lanes
   (66,560 steady solves in one call; no kernel may launch). Each first
   and, 13a and 13b, warm (the same launches), with walls, lanes/s, peak
   memory, host syncs, NaN lanes and launches; 13c also prints the lane
   that ends not ok (:data:`DRC_FD_EDGE_LANE`). On the card, every lane
   with finite xi holds the sum rule |sum_r xi_r - 1| <= 1e-6 in 13a and
   13b (scaling every k scales the TOF of the infinite-dilution reactor
   by the same factor) with the term the solve's residual adds to it
   (see :func:`sum_rule`).
   :data:`SUBSET` lanes of 13a re-run on the CPU, and
   :data:`DRC_SUBSET` lanes each of 13b and 13c in worker processes,
   from the states of their sweeps: NaN lanes and ``ok`` equal, xi
   within rtol 1e-6 / atol 1e-9 (:data:`DRC_ENVELOPE`), else within
   twice the CPU's own spread with T up, T down and kscale up by one
   ulp. Phase 7's CPU comparisons wait until after phase 11, phase
   12's first two until after phase 13, its last until after phase 9's
   timings;
14. the f32-polish precision tier: ``sweep_steady_state(...,
   tier="f32-polish")`` on the unpadded flagship (65,536 lanes, n = 21,
   Gauss-Jordan in float32, no kernel), the ABI flagship (65,536 lanes,
   D = 32, the float32 warp tier) and the large ABI path (2,048 lanes,
   D = 256, the float32 panel tier), first call and warm, each against
   the same path's float64 run (see :func:`tier_path`: verdicts bitwise,
   float32 launches, a CPU prefix of 256 (16) lanes at the same tier in
   the worker pool, the counts of lanes whose strategy column or root
   differs from float64's);
15. the packed multi-tenant sweep: four tenants of one bucket (D = 32) x
   16,384 lanes under both tiers, each tenant's dict equal to its solo
   sweep's bit for bit, the packed launches and host syncs beside the
   solo sweeps', then a K = 3 pack (see :func:`pack_phase`);
16. serve: the sweep server (``pycatkin_tpu_torch.serve``) on the card.
   (a) the soak (``serve.soak.run_soak``) over TCP at its default mix:
   buckets 16, 32 and 128, 4 lanes a request, 6 mechanisms a bucket,
   ``max_occupancy`` 8, concurrency 16, :data:`SERVE_REQUESTS` measured
   sweep requests; ``check_soak_record`` must pass (no failure, every
   response schema-complete, p99 within 30 s), and the first
   :data:`SERVE_AUDIT` measured answers are each re-run as a solo call on
   the card (the mechanism read back from its wire form, as the server
   reads it) with ``canonical_answer`` byte-identical; ``lu_factor`` and
   ``lu_solve`` must launch, counted by n and lanes. (b) through a server
   of their own: three transient requests (:data:`SERVE_TRANSIENTS`) on
   the soak's save grid 0, 1e-9 .. 1 s, the two of one bucket in one
   packed flush, each byte-identical to its solo
   ``batch_transient(abi=True)``; then, through another, full
   width: one 65,536-lane sweep request of the ABI flagship,
   byte-identical to a direct
   ``sweep_steady_state(..., abi=True)`` at the coalescer's options
   (``check_stability=False``, float64), then phase 15's four
   16,384-lane tenants submitted together, which must come back as one
   packed flush (``pack.tenants == 4``), each byte-identical to a direct
   ``packed_sweep_steady_state`` of the four (see :func:`serve_phase`).
   It runs before the script waits on phase 12's last CPU re-run;
17. the robustness layer on the card (see :func:`robust_phase`).
   (a) the ABI flagship's 65,536 lanes as four journaled chunks of
   :data:`ROBUST_CHUNK` (``robustness.chunked_sweep_steady_state(...,
   abi=True, check_stability=True)``): undisturbed, where no ladder rung
   may fire;
   then under a fault plan with ``DegradationPolicy(host_fallback=
   False)`` (a transient fault at ``chunk:1``, absorbed by the retry
   rung; a permanent one at ``chunk:2``, salvaged; NaN on
   :data:`ROBUST_NAN_LANES` of chunk 3's first pass and on every rescue,
   so those lanes stay quarantined and the chunk is journaled
   ``quarantined``); then resumed from that journal, which must re-solve
   exactly the salvaged and quarantined chunks, reuse the rest and give
   the undisturbed run's bits (kernels-line path ``chunked_abi``, one row
   per kernel, n and lane count of the undisturbed run). (b)
   :data:`ELASTIC_LANES` lanes of the same mechanism through
   ``robustness.run_elastic`` (two worker processes on the card, chunk
   :data:`ELASTIC_CHUNK`, one ``worker-crash`` at ``worker:0``) and,
   beside it, through ``dispatch_sweep(mode="static", n_workers=2)``,
   each bit for
   bit the in-process chunked sweep of the same chunk grid on the card
   (a worker on the CPU would not be; the elastic run's reference is the
   one-deep double buffer, ``pipeline=True``, so the equality also holds
   it to the serial sweeps of the workers), the elastic run with at
   least one restart. (c) phase 12's ESDIRK4 ``abi=True`` transient on
   the chunked route (``batch_transient(fused=False,
   force_chunking=True)``), bit for bit phase 12's fused result and with
   its launches (kernels-line path ``transient_chunked``);
18. the fleet on the card (see :func:`fleet_phase`): the chaos drill
   (``serve.soak.run_chaos_drill``, :data:`FLEET_DRILL`): 24 requests of
   3 lanes at bucket 32 (4 mechanisms, ``max_occupancy`` 4) answered
   first by an undisturbed in-process server on the card (the baseline),
   then through the front router by three replica processes on the same
   card (``python -m pycatkin_tpu_torch.serve --device cuda``, each
   loading the kernel library before it serves), two of them SIGKILLed
   mid-stream and the journal-backed router process killed too, with a
   reset connection and a torn line at the router's dispatch sites.
   ``check_chaos_record`` must find nothing: no request lost, every answer
   and every journaled answer (fetched by key from the rebooted router)
   bitwise the baseline's, a clean duplicate audit, both killed replicas
   back at incarnation 2 or more, the router back, and no replica flush
   that built or loaded the kernel library. Each replica counts its own
   kernel launches since its start and reports them in its stats: every
   replica that served must have launched kernels, and the replicas
   together ``lu_factor`` and ``lu_solve`` at n = 16 (kernels-line path
   ``serve_fleet``, with the replicas' counts). The phase line gives its
   walls and the baseline's launches beside the replicas'.

Every path runs with the launch counters zeroed just before it and read
just after. It prints one line per phase, a ``{"kernels": [...]}`` JSON
line with one row per kernel per path that launches it (``path``:
``certificate``, ``abi_flagship``, ``abi_certificate``, ``rescue_abi``,
``large``, ``large_abi``, ``transient``, ``transient_abi``,
``transient_esdirk4``, ``drc_large``, ``abi_flagship_f32``,
``large_abi_f32``, ``packed``, ``packed_f32``, ``serve``,
``serve_transient``, ``serve_full``, ``chunked_abi``,
``transient_chunked`` or ``serve_fleet``, the serve paths and
``chunked_abi`` with one row per kernel, n and lane count they launched
at; the float32 kernels are named ``lu_factor_f32`` etc.; each distinct
kernel, n, lane count and type is checked and timed once, and every row
at that shape carries its numbers), the
nvidia-smi line, and last ``{"ok": true, "device": {...}}``. Any
failure raises and exits non-zero; without a CUDA card it exits 1 and
prints no result.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# FP64 peak of one H100 SXM (NVIDIA data sheet: 67 TFLOP/s on the FP64
# tensor cores, 34 TFLOP/s on the FP64 vector units) and its HBM3 rate.
PEAK_FP64_FLOPS = 67.0e12
PEAK_BYTES_PER_S = 3.35e12
# FP64 vector instructions an H100 SXM issues a second: 132 SMs x 64
# FP64 units x 1.98 GHz boost clock (the data sheet's 34 TFLOP/s counts
# an FMA as two operations).
FP64_VECTOR_INSTR_PER_S = 132 * 64 * 1.98e9
# FP32 outside the tensor cores: 67 TFLOP/s (the data sheet), and the
# vector instructions a second of 132 SMs x 128 FP32 units at 1.98 GHz.
PEAK_FP32_FLOPS = 67.0e12
FP32_VECTOR_INSTR_PER_S = 132 * 128 * 1.98e9
SIZES = (9, 16, 21, 32, 54, 64, 112, 128, 165, 170, 200, 256, 512)
KERNEL_TOL = 1e-12
# The float32 kernels' x gate: KERNEL_TOL scaled by eps32 / eps64 (~5.4e-4).
F32_KERNEL_TOL = KERNEL_TOL * 2.0 ** -23 / 2.0 ** -52
# Phase 14: the f32-polish tier's states against the float64 sweep's, the
# envelope of tests/test_precision_tiers.py (_Y_TOL).
Y_TOL = dict(rtol=5e-2, atol=1e-12)
PACK_LANES = 16384       # phase 15: lanes of each of the four tenants
PACK_SEEDS = (0, 1, 2, 3)
PACK3_LANES = 1024       # phase 15: the K = 3 pack's lanes a tenant
# Phase 16a: measured soak requests, sweeps only (100 until phase 17:
# with 100 and the warm re-runs below, phases 1-17 ended at 1,139 s of
# the 1,200 s limit on an H100 80GB HBM3 at 700 W whose host ran slow,
# PERF.md). The soak's tenth of
# transients does not fit the time limit: at 60 requests it took 461 s
# on an H100 80GB HBM3 at 700 W, most of it the warm-up's packed
# transient flushes (PERF.md section 5).
SERVE_REQUESTS = 50
SERVE_AUDIT = 32         # phase 16a: answers re-run as solo calls
# Phase 16b's transient requests: (bucket, seed) of
# synthetic_system_for_bucket, two of one bucket (one packed flush) and
# one of another, on the soak's save grid; ~40-60 batch steps each.
SERVE_TRANSIENTS = ((16, 1), (16, 4), (32, 1))
# Phase 17: the chunked ABI flagship's chunk (four chunks of 65,536
# lanes), the lanes of its chunk 3 poisoned in the faulted run, and the
# elastic and static runs' lanes and chunk.
ROBUST_CHUNK = 16384
ROBUST_NAN_LANES = (3, 4097, 12000)
ELASTIC_LANES = 8192
ELASTIC_CHUNK = 2048
# Phase 18: the chaos drill's settings, the JAX package's defaults but
# bucket 32 (bucket 16's D goes to Gauss-Jordan and reaches no kernel)
# and the router killed too, as its command line does by default; and
# the drill's time limit, seconds.
FLEET_DRILL = dict(bucket=32, n_requests=24, lanes=3, mechs=4,
                   n_replicas=3, kill=2, max_occupancy=4,
                   router_crash=True, with_pack=True)
FLEET_LIMIT_S = 300.0
FLAGSHIP_LANES = 65536   # bench.py's default 256 x 256 grid
CERT_LANES = 4096
ABI_CERT_LANES = 65536
LARGE_LANES = 2048       # synthetic (200, 200): ~20 GiB peak at D = 256
CHECK_LANES = 4096       # well-conditioned lanes per kernel check size
LARGE_CHECK_LANES = 128  # well-conditioned lanes per check size above 128
RESCUE_OPTS = dict(max_steps=6, max_attempts=3)   # phase 10's options
ENTRY_LANES = 65536      # phase 11, the flagship entry
SUBSET = 256             # lanes of each path re-run on the CPU
LARGE_SUBSET = 16        # the same for the large path
# Phase 12: (kernels-line path, mechanism, lanes, abi, method) of each
# transient path, all over T 400-800 K and transient_grid(), in this
# order (the slowest CPU re-run, transient_abi's, gets the longest
# overlap with the card). The TR-BDF2 paths are cut from 65,536 and
# 16,384 lanes (warm walls 131.5 s and 205.7 s on an H100 80GB HBM3 at
# 700 W) to where a full-width step's device time falls to its ~12 ms
# of host time; below that the wall is the slowest lane's ~5,900 (or
# ~5,100) steps times the host time and does not shrink (PERF.md).
TRANSIENT_PATHS = (
    ("transient", (24, 32), 16384, False, "trbdf2"),
    ("transient_esdirk4", (24, 32), 4096, True, "esdirk4"),
    ("transient_abi", (24, 32), 4096, True, "trbdf2"),
)
TRANSIENT_SUBSET = 16    # lanes of each transient path re-run on the CPU
# Seconds after the start by which a transient path's one-ulp CPU re-runs
# (of its lanes outside the envelope, if any) must be back: the kernels
# line still needs ~40 s, and the whole script must end within 1,200 s.
TRANSIENT_GATE_BY = 1100.0
STEP_PROFILE_STEPS = 20  # steps of the profiled first save interval
# Phases 12 and 13: a path whose first run took longer is not re-run warm
# (the TR-BDF2 transients' ~100-150 s each, and since phase 17 the
# ESDIRK4 transient's ~23-30 s and 13c's ~45-55 s, would not fit the time
# limit; their warm runs differed from the first by 0.5-12 %, PERF.md);
# the transients' step profiles repeat a short run instead, and phase 17c
# re-runs ESDIRK4 on the chunked route with phase 12's launches.
WARM_RERUN_MAX_S = 20.0
DRC_FD_LANES = 1024      # phase 13c: 1,024 x (2 n_r + 1) = 66,560 solves
DRC_SUBSET = 16          # lanes of 13b and 13c re-run in a worker
# Phase 13c: the flagship lane (T 401.56 K, index 4 of the 1,024) whose
# FD DRC the card ends not ok. The JAX package on the CPU ends it not ok
# too from the card's states, and ok one ulp off in T or kscale, as the
# port on the CPU does at all four (ROADMAP.md Queue C item 6;
# tests/test_torch_drc.py). Its CPU re-run is reported beside the gated
# subset, not gated: its verdict flips within the one-ulp spread.
DRC_FD_EDGE_LANE = 256
DRC_ENVELOPE = dict(rtol=1e-6, atol=1e-9)
SUM_RULE_TOL = 1e-6
NARROW_LANES = 512       # the unpadded transient's step profile, narrow
REPS = 20                # timed calls per kernel
ENVELOPE = dict(rtol=1e-5, atol=1e-12)
# The large path's envelope. On an H100 its states sit 4.3e-11 from the
# CPU's (the engine's reductions round differently on the card; the LU
# kernels are bit for bit), while the reference itself moves them by
# 1.2e-7 under a one-ulp change of T or kscale: 1e-9 lies between, ~20
# times the gap and ~100 times below the spread.
LARGE_ENVELOPE = dict(rtol=1e-5, atol=1e-9)
# The card converges to normalized residual <= 1 by its own evaluation;
# two evaluations of the residual agree to rtol 1e-12 of |F| + gross
# (tests/test_torch_network.py), which moves the normalized residual
# |F| / (rate_tol + rate_tol_rel gross) by up to 1e-12 / 1e-9.
RESIDUAL_SLACK = 1e-3
# Phase 14: (label, mechanism, lanes, abi, check_stability, CPU prefix,
# the states' envelope there) of each path run under the f32-polish tier
# beside its float64 run: the unpadded flagship (Gauss-Jordan, whose
# states the reference moves by ~1e-4 under one ulp, hence no envelope:
# the one-ulp rule), the ABI flagship and the large ABI path.
TIER_PATHS = (
    ("flagship", (24, 32), FLAGSHIP_LANES, False, True, SUBSET, None),
    ("abi_flagship", (24, 32), FLAGSHIP_LANES, True, True, SUBSET,
     ENVELOPE),
    ("large_abi", (200, 200), LARGE_LANES, True, False, LARGE_SUBSET,
     LARGE_ENVELOPE),
)


START = time.perf_counter()


def log(msg: str) -> None:
    """Print a line; a phase line ends with the seconds since start."""
    if msg.startswith("phase"):
        msg += f" [t {time.perf_counter() - START:.1f} s]"
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


def host_us(fn, reps: int) -> float:
    """Mean host time of one ``fn()`` in microseconds over ``reps``
    back-to-back calls, none of which waits for the card (the launches
    queue behind each other), after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def lu_flops(n: int) -> float:
    """FP64 operations of one partial-pivoted LU: per step one division
    and one multiply-subtract per trailing entry."""
    return float(sum(m + 2 * m * m for m in range(1, n)))


def solve_flops(n: int, k: int = 1) -> float:
    """FP64 operations of the two triangular passes for k right-hand
    sides."""
    return float(k * (2 * n * n - n))


def lu_updates(n: int) -> float:
    """Rank-1 update entries of one partial-pivoted LU."""
    return float(sum(m * m for m in range(1, n)))


def vector_floor_ms(updates: float, f32: bool = False) -> float:
    """Least time for ``updates`` multiply-subtracts on the FP64 (or
    FP32) vector units when each must round twice (the kernels' contract
    forbids FMA, so the tensor cores, whose DMMA fuses the multiply-add,
    are out): two instructions per update."""
    rate = FP32_VECTOR_INSTR_PER_S if f32 else FP64_VECTOR_INSTR_PER_S
    return 2.0 * updates / rate * 1e3


def bound(bytes_moved: float, flops: float, f32: bool = False):
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / (PEAK_FP32_FLOPS if f32 else PEAK_FP64_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def test_matrices(lanes: int, n: int, seed: int, device, dtype=None):
    """``lanes`` diagonally dominant (well-conditioned) row-shuffled
    systems plus one singular lane (a zero column) at the end, in
    ``dtype`` (float64 unless given)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((lanes + 1, n, n))
    A += 2.0 * n * np.eye(n)
    for i in range(0, lanes, 7):
        A[i] = A[i][rng.permutation(n)]
    A[-1, :, n // 2] = 0.0
    b = rng.standard_normal((lanes + 1, n))
    t = lambda a: torch.tensor(a, dtype=torch.float64, device=device).to(
        dtype or torch.float64)
    return t(A), t(b)


def timing_matrices(L: int, n: int, seed: int, device, dtype=None):
    """The operands of a timed kernel at ``L`` lanes: :func:`test_matrices`
    with its singular lane last, or at ``L`` = 1 one well-conditioned
    lane. Returns ``(A, b, good)``, ``good`` the slice of the
    well-conditioned lanes."""
    A, b = test_matrices(max(L - 1, 1), n, seed=seed, device=device,
                         dtype=dtype)
    if L == 1:
        return A[:1].contiguous(), b[:1].contiguous(), slice(0, 1)
    return A, b, slice(0, L - 1)


def rel_err(a, b) -> float:
    import torch
    return float(torch.max(torch.abs(a - b)) / torch.max(torch.abs(b)))


def check_lanes(n: int) -> int:
    """Well-conditioned lanes of the kernel check at size n: the
    flagship's lane count at the warp tier's n = 16 and 32 (65,536 + 1
    leaves a partial last block), fewer above n = 128."""
    if n in (16, 32):
        return FLAGSHIP_LANES
    return CHECK_LANES if n <= 128 else LARGE_CHECK_LANES


def check_kernels(cl, device, dtype) -> None:
    """Phase 2a: each kernel of element type ``dtype`` against its plain
    version at every size (x within :data:`KERNEL_TOL`, in float32
    :data:`F32_KERNEL_TOL`)."""
    import torch
    tol = F32_KERNEL_TOL if dtype == torch.float32 else KERNEL_TOL
    unequal = []
    for n in SIZES:
        lanes = check_lanes(n)
        A, b = test_matrices(lanes, n, seed=n, device=device, dtype=dtype)
        B = b[:, :, None].repeat(1, 1, 4).contiguous()
        LU, perm = cl.lu_factor(A)
        torch.cuda.synchronize()
        LUr, permr = cl.lu_factor_ref(A)
        good = slice(0, lanes)
        assert torch.equal(perm[good], permr[good]), f"lu_factor n={n}: perm"
        e_lu = rel_err(LU[good], LUr[good])
        assert torch.equal(LU[good], LUr[good]), \
            f"lu_factor n={n}: LU differs from the plain version's (rel " \
            f"err {e_lu})"
        errs, eq = {}, {}
        for name, rhs in (("vec", b), ("mat", B)):
            x = cl.lu_solve(LU, perm, rhs)
            torch.cuda.synchronize()
            xr = cl.lu_solve_ref(LUr, permr, rhs)
            xf = cl.factor_solve(A, rhs)
            torch.cuda.synchronize()
            xfr = cl.factor_solve_ref(A, rhs)
            e1, e2 = rel_err(x[good], xr[good]), rel_err(xf[good], xfr[good])
            assert e1 <= tol, f"lu_solve n={n} {name}: {e1}"
            assert e2 <= tol, f"factor_solve n={n} {name}: {e2}"
            for out in (x, xf):
                assert not bool(torch.isfinite(out[-1]).all()), \
                    f"n={n} {name}: singular lane came out finite"
                assert bool(torch.isfinite(out[good]).all()), \
                    f"n={n} {name}: a well-conditioned lane is non-finite"
            # Both solves take each entry's updates in the same order.
            eq[name] = torch.equal(x[good], xf[good])
            if not eq[name]:
                unequal.append(f"n={n} {name}")
            errs[name] = max(e1, e2)
        assert not bool(torch.isfinite(LU[-1]).all())
        log(f"kernel check {str(dtype)[6:]} n={n}: {lanes}+1 lanes, perm and "
            f"LU equal, x rel "
            f"err vec {errs['vec']:.2e} mat {errs['mat']:.2e}, lu_solve and "
            f"factor_solve bit for bit vec {eq['vec']} mat {eq['mat']}, "
            f"singular lane non-finite")
    assert not unequal, \
        f"lu_solve(*lu_factor(A), b) differs from factor_solve(A, b): {unequal}"


def time_lu(cl, n: int, L: int, device, dtype=None) -> list:
    """Phase 2b: ``lu_factor`` and ``lu_solve`` at ``L`` lanes of size
    ``n`` (the last lane singular) beside their plain versions and the
    matching torch.linalg calls, in ``dtype`` (float64 unless given; the
    float32 rows are named ``*_f32``); returns one row each."""
    import torch
    f32 = dtype == torch.float32
    sfx, e, tol = ("_f32", 4, F32_KERNEL_TOL) if f32 else ("", 8, KERNEL_TOL)
    A, b, g = timing_matrices(L, n, seed=n, device=device, dtype=dtype)
    LU, perm = cl.lu_factor(A)
    LUr, permr = cl.lu_factor_ref(A)
    lu_err = float(torch.max(torch.abs(LU[g] - LUr[g])))
    assert torch.equal(perm[g], permr[g]), f"lu_factor n={n} x {L}: perm"
    assert torch.equal(LU[g], LUr[g]), \
        f"lu_factor n={n} x {L}: LU differs from the plain version's " \
        f"({lu_err})"
    ms = cuda_ms(lambda: cl.lu_factor(A), REPS)
    hus = host_us(lambda: cl.lu_factor(A), REPS)
    plain = cuda_ms(lambda: cl.lu_factor_ref(A), 2)
    lib = cuda_ms(lambda: torch.linalg.lu_factor_ex(A), REPS)
    bms, by = bound(L * (2 * n * n * e + n * 4), L * lu_flops(n), f32)
    rows = [dict(name="lu_factor" + sfx, n=n, lanes=L, max_abs_err=lu_err,
                 ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                 library_ms=lib, host_us=hus,
                 vector_floor_ms=vector_floor_ms(L * lu_updates(n), f32))]

    x = cl.lu_solve(LU, perm, b)
    xr = cl.lu_solve_ref(LUr, permr, b)
    sol_err = float(torch.max(torch.abs(x[g] - xr[g])))
    err = rel_err(x[g], xr[g])
    assert err <= tol, f"lu_solve n={n} x {L}: rel err {err}"
    tLU, tpiv, _ = torch.linalg.lu_factor_ex(A)
    ms = cuda_ms(lambda: cl.lu_solve(LU, perm, b), REPS)
    hus = host_us(lambda: cl.lu_solve(LU, perm, b), REPS)
    plain = cuda_ms(lambda: cl.lu_solve_ref(LU, perm, b), 2)
    lib = cuda_ms(lambda: torch.linalg.lu_solve(tLU, tpiv, b[:, :, None]),
                  REPS)
    bms, by = bound(L * (n * n * e + n * 4 + 2 * n * e),
                    L * solve_flops(n), f32)
    rows.append(dict(name="lu_solve" + sfx, n=n, lanes=L,
                     max_abs_err=sol_err, ms=ms, plain_ms=plain,
                     bound_ms=bms, bound_by=by, library_ms=lib, host_us=hus,
                     vector_floor_ms=vector_floor_ms(L * (n * n - n), f32)))
    return rows


def time_factor_solve(cl, n: int, L: int, device, dtype=None) -> dict:
    """Phase 2b: ``factor_solve`` at ``L`` lanes of size ``n`` beside its
    plain version and ``torch.linalg.solve_ex``, in ``dtype`` (float64
    unless given); returns its row."""
    import torch
    f32 = dtype == torch.float32
    sfx, e, tol = ("_f32", 4, F32_KERNEL_TOL) if f32 else ("", 8, KERNEL_TOL)
    A, b, g = timing_matrices(L, n, seed=2, device=device, dtype=dtype)
    xf = cl.factor_solve(A, b)
    xfr = cl.factor_solve_ref(A, b)
    fs_err = float(torch.max(torch.abs(xf[g] - xfr[g])))
    err = rel_err(xf[g], xfr[g])
    assert err <= tol, f"factor_solve n={n} x {L}: rel err {err}"
    ms = cuda_ms(lambda: cl.factor_solve(A, b), REPS)
    hus = host_us(lambda: cl.factor_solve(A, b), REPS)
    plain = cuda_ms(lambda: cl.factor_solve_ref(A, b), 2)
    lib = cuda_ms(lambda: torch.linalg.solve_ex(A, b), REPS)
    bms, by = bound(L * (n * n * e + 2 * n * e),
                    L * (lu_flops(n) + solve_flops(n)), f32)
    return dict(name="factor_solve" + sfx, n=n, lanes=L, max_abs_err=fs_err,
                ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                library_ms=lib, host_us=hus, vector_floor_ms=vector_floor_ms(
                    L * (lu_updates(n) + n * n - n), f32))


def check_gauss(device) -> None:
    """Phase 2c: the plain-PyTorch Gauss-Jordan route (what n <= 48 off
    the buckets takes) on the card against the same call on the CPU."""
    import torch
    from pycatkin_tpu_torch.ops import linalg
    good = slice(0, CHECK_LANES)
    for n in (8, 21):
        A, b = test_matrices(CHECK_LANES, n, seed=n + 1, device=device)
        x, Ainv = linalg.gauss_solve(A, b), linalg.inv(A)
        torch.cuda.synchronize()
        xc, Ainvc = linalg.gauss_solve(A.cpu(), b.cpu()), linalg.inv(A.cpu())
        e_x = rel_err(x[good].cpu(), xc[good])
        e_inv = rel_err(Ainv[good].cpu(), Ainvc[good])
        same = torch.equal(x[good].cpu(), xc[good]) and torch.equal(
            Ainv[good].cpu(), Ainvc[good])
        assert max(e_x, e_inv) <= KERNEL_TOL, (n, e_x, e_inv)
        log(f"gauss check n={n}: {CHECK_LANES} lanes, card vs CPU rel err "
            f"x {e_x:.2e} inverse {e_inv:.2e}, bit for bit {same}")


def check_prng(device) -> None:
    """Phase 2d: the threefry keys and uniform draws of the rescue
    ladder's restarts on the card against the same calls on the CPU."""
    import torch
    from pycatkin_tpu_torch.ops import prng
    keys = prng.split(prng.prng_key(0, device), FLAGSHIP_LANES)
    draws = prng.uniform(prng.split(keys)[:, 1], (32,))
    torch.cuda.synchronize()
    keys_c = prng.split(prng.prng_key(0), FLAGSHIP_LANES)
    assert torch.equal(keys.cpu(), keys_c), "prng: split differs"
    assert torch.equal(draws.cpu(), prng.uniform(prng.split(keys_c)[:, 1],
                                                 (32,))), "prng: uniform"
    log(f"prng check: {FLAGSHIP_LANES} keys and 32 uniform draws each, bit "
        f"for bit the CPU's")


def counted(run):
    """``run()`` with the launch counters and the sync and step counters
    zeroed just before and read just after; returns (output, counts,
    syncs, wall seconds). ``counts`` holds the float64 kernels' launches
    by name and the float32 kernels' as ``<name>_f32``; ``syncs`` counts
    the solver loops' checks, the integrator's and the sweeps' bundle
    pulls."""
    import torch
    from pycatkin_tpu_torch.ops import cuda_linalg as cl
    from pycatkin_tpu_torch.solvers import newton, ode
    torch.cuda.synchronize()
    cl.reset_launches()
    newton.reset_syncs()
    ode.reset_counters()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    syncs = sum(newton.SYNCS.values()) + sum(ode.SYNCS.values())
    counts = dict(cl.LAUNCHES)
    counts.update({k + "_f32": v for k, v in cl.LAUNCHES_F32.items()})
    return out, counts, syncs, wall


def fused(spec, conds, mask, device):
    from pycatkin_tpu_torch.parallel import batch
    return lambda: batch.fused_sweep(spec, conds, mask, device=device)


def abi_sweep(spec, conds, mask, device, check_stability=True):
    from pycatkin_tpu_torch.parallel import batch
    return lambda: batch.sweep_steady_state(
        spec, conds, mask, check_stability=check_stability, abi=True,
        device=device)


def lanes_over_T(base, L):
    from pycatkin_tpu_torch.parallel import batch
    import numpy as np
    return batch.broadcast_conditions(base, L)._replace(
        T=np.linspace(400.0, 800.0, L))


def cpu_subset(conds, size: int = SUBSET):
    """``size`` evenly spaced lanes of ``conds``: (indices, conditions)."""
    import numpy as np
    L = len(conds.T)
    idx = np.linspace(0, L - 1, size).round().astype(np.int64)
    return idx, type(conds)(*(np.asarray(f)[idx] for f in conds))


def envelope_gap(a, b, envelope=ENVELOPE) -> tuple:
    """(max |a - b|, max |a - b| / (atol + rtol |b|)): the second is at
    most 1 inside the envelope."""
    import torch
    d = torch.abs(a - b)
    return float(d.max()), float(torch.max(
        d / (envelope["atol"] + envelope["rtol"] * torch.abs(b))))


def profile_path(run, lanes: int, label: str) -> float:
    """Phase 8: a warm re-run of a path, then one under torch.profiler:
    warm wall, device-busy share and the top device kernels by time.
    Returns the warm wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    _, counts, syncs, wall = counted(run)
    log(f"phase 8 warm {label}: wall {wall:.3f} s, {lanes / wall:.1f} "
        f"lanes/s, host syncs {syncs}, launches {counts}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, _, pwall = counted(run)
    # Device time = the kernels' and copies' own intervals on the card
    # (events of device type CUDA; operator rows would count them twice).
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e6
    by_name: dict = {}
    for e in kernels:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    log(f"phase 8 profile {label}: wall under the profiler {pwall:.3f} s, "
        f"device busy {busy:.3f} s ({100.0 * busy / pwall:.1f} % of wall), "
        f"{len(kernels)} device kernels and copies")
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[
            :15]:
        log(f"phase 8 kernel {label} {name[:70]!r}: {t / 1e3:.1f} ms, "
            f"{c} calls, {100.0 * t / 1e6 / busy:.1f} % of device time")
    return wall


def verdicts(out):
    res, quar, cert, amb, tofs, act, neg = out[:7]
    return {"success": res.success, "quarantined": quar, "certified": cert,
            "ambiguous": amb, "negative_tof": neg}


def cpu_normalized_residual(spec, conds, x):
    """The solver's convergence measure, evaluated by the port's engine
    on the CPU at full states ``x`` ``[L, n_s]``: per lane, max over the
    dynamic species of ``|F_i| / (rate_tol + rate_tol_rel * gross_i)``
    (converged when <= 1)."""
    from pycatkin_tpu_torch import engine
    from pycatkin_tpu_torch.solvers import newton
    ds = engine.bind(spec, "cpu")
    ct = engine.conditions_to(conds, "cpu")
    kf, kr, _ = engine.rate_constants(ds, ct)
    F, gross = engine.closures(ds, ct, kf, kr).fscale(
        x[:, list(spec.dynamic_indices)])
    return newton._rnorm(F, gross, newton.SolverOptions())


def one_ulp_conditions(sub) -> tuple:
    """``sub`` with T up, T down and kscale up by one ulp."""
    ulp = 1.0 + 2.0 ** -52
    return (sub._replace(T=sub.T * ulp), sub._replace(T=sub.T / ulp),
            sub._replace(kscale=sub.kscale * ulp))


def one_ulp_gate(label, spec, sub, rerun, ref, out, idx, fields,
                 envelope=None, steady=True, runs=None) -> str:
    """The gate for a route whose states the reference itself does not
    reproduce to the rtol 1e-5 / atol 1e-12 envelope: the CPU lanes
    ``sub`` run three more times through ``rerun`` with T up, T down and
    kscale up by one ulp (:func:`one_ulp_conditions`; or ``runs``, those
    three outputs already computed). Each field (name -> getter of an
    output) of the card's lanes ``idx`` of ``out`` must lie within twice
    the largest spread of those runs around ``ref`` or, given an
    ``envelope``, within it; and the card's states (field ``x``: full
    states ``[L, n_s]``) must pass the solver's convergence test
    evaluated on the CPU (the standard of
    tests/test_torch_sweep.py::test_flagship_matches_stock_jax; not for
    ``steady=False``, a transient's trajectories). Returns the log
    text."""
    import torch
    if runs is None:
        runs = [rerun(c) for c in one_ulp_conditions(sub)]
    parts = []
    for name, get in fields.items():
        r0 = get(ref)
        spread = max(float(torch.max(torch.abs(get(r) - r0))) for r in runs)
        gap, frac = envelope_gap(get(out)[idx].cpu(), r0,
                                 envelope or ENVELOPE)
        if envelope is None:
            assert gap <= 2.0 * spread, \
                f"{label} CPU subset parity: {name} differs by {gap}, " \
                f"twice the one-ulp spread is {2.0 * spread}"
            held = ""
        else:
            assert frac <= 1.0, \
                f"{label} CPU subset parity: {name} differs by {gap}, " \
                f"{frac:.3g} of the rtol {envelope['rtol']:g} / atol " \
                f"{envelope['atol']:g} envelope"
            held = f" ({frac:.3g} of the envelope)"
        parts.append(f"{name} max gap {gap:.3e}{held} vs one-ulp spread "
                     f"{spread:.3e}")
    if not steady:
        return "; ".join(parts)
    x = fields["x"](out)[idx].cpu()
    rn = float(cpu_normalized_residual(spec, sub, x).max())
    assert rn <= 1.0 + RESIDUAL_SLACK, \
        f"{label} CPU subset parity: the card's states fail the " \
        f"convergence test on the CPU (normalized residual {rn})"
    return "; ".join(parts) + f"; normalized residual of the card's " \
        f"states on the CPU {rn:.3g}"


def fused_cpu_parity(label, spec, conds, mask, out, hold_states,
                     subset: int = SUBSET, envelope=None, cpu=None):
    """``subset`` lanes of a ``fused_sweep`` path re-run on the CPU
    through the plain versions: verdicts equal. Where ``hold_states``,
    states within the envelope; else :func:`one_ulp_gate` (with
    ``envelope``) on states, TOF and activity. ``cpu``: those re-runs
    already made (:func:`large_cpu_rerun`)."""
    import torch
    from pycatkin_tpu_torch.parallel import batch
    idx, sub = cpu_subset(conds, subset)
    rerun = lambda c: batch.fused_sweep(spec, c, mask, device="cpu")
    out_cpu = rerun(sub) if cpu is None else cpu[0]
    v, vc = verdicts(out), verdicts(out_cpu)
    for name in v:
        assert torch.equal(v[name][idx].cpu(), vc[name]), \
            f"{label} CPU subset parity: {name} differs"
    dx, frac = envelope_gap(out[0].x[idx].cpu(), out_cpu[0].x)
    head = (f"{label} CPU parity: {subset} lanes re-run on the CPU through "
            f"the plain versions")
    if hold_states:
        assert frac <= 1.0, f"{label} CPU subset parity: states differ by {dx}"
        log(f"{head}: verdicts equal, max |dx| {dx:.3e} ({frac:.3g} of the "
            f"rtol 1e-5 / atol 1e-12 envelope)")
        return
    fields = {"x": lambda o: o[0].x, "tof": lambda o: o[4],
              "activity": lambda o: o[5]}
    gate = one_ulp_gate(label, spec, sub, rerun, out_cpu, out, idx, fields,
                        envelope, runs=None if cpu is None else cpu[1:])
    log(f"{head}, and with T up, T down, kscale up one ulp: verdicts equal, "
        f"max |dx| {dx:.3e} ({frac:.3g} of the rtol 1e-5 / atol 1e-12 "
        f"envelope); {gate}")


def abi_cpu_parity(label, spec, conds, mask, out, check_stability=True,
                   hold_states=True, subset: int = SUBSET, envelope=None,
                   cpu=None):
    """``subset`` lanes of an ABI path re-run on the CPU through the plain
    versions: verdict masks equal. Where ``hold_states``, states within
    the envelope; else :func:`one_ulp_gate` (with ``envelope``) on
    states, TOF and activity. ``cpu``: those re-runs already made
    (:func:`large_cpu_rerun`)."""
    import torch
    from pycatkin_tpu_torch.parallel import batch
    idx, sub = cpu_subset(conds, subset)
    rerun = lambda c: batch.sweep_steady_state(
        spec, c, mask, check_stability=check_stability, abi=True,
        device="cpu")
    ref = rerun(sub) if cpu is None else cpu[0]
    names = ("success", "stable", "quarantined") if check_stability \
        else ("success", "quarantined")
    for name in names:
        assert torch.equal(out[name][idx].cpu(), ref[name]), \
            f"{label} CPU subset parity: {name} differs"
    dx, frac = envelope_gap(out["y"][idx].cpu(), ref["y"])
    tof = out["tof"][idx].cpu()
    dtof = float(torch.max(torch.abs(tof - ref["tof"])
                           / torch.abs(ref["tof"])))
    head = (f"{label} CPU parity: {subset} lanes re-run on the CPU through "
            f"the plain versions")
    if hold_states:
        assert frac <= 1.0, f"{label} CPU subset parity: states differ by {dx}"
        log(f"{head}: {', '.join(names)} equal, max |dy| {dx:.3e} "
            f"({frac:.3g} of the envelope), max TOF rel diff {dtof:.3e}")
        return
    fields = {"x": lambda o: o["y"], "tof": lambda o: o["tof"],
              "activity": lambda o: o["activity"]}
    gate = one_ulp_gate(label, spec, sub, rerun, ref, out, idx, fields,
                        envelope, runs=None if cpu is None else cpu[1:])
    log(f"{head}, and with T up, T down, kscale up one ulp: "
        f"{', '.join(names)} equal, max |dy| {dx:.3e} ({frac:.3g} of the "
        f"envelope), max TOF rel diff {dtof:.3e}; {gate}")


def report_abi(label, low, L, out, counts, syncs, wall, peak, note=""):
    """Log an ABI run; every lane must converge (and, where the run
    checked stability, be stable) with finite states and TOF."""
    import torch
    y = out["y"]
    assert y.shape == (L, low.n_s_real), y.shape
    ok = out["success"] & out["stable"] if "stable" in out \
        else out["success"]
    assert bool(ok.all())
    assert bool(torch.isfinite(y).all())
    assert bool(torch.isfinite(out["tof"]).all())
    it = out["iterations"]
    verdict = "converged and stable" if "stable" in out else "converged"
    log(f"{label}: S={low.static.n_species} R={low.static.n_reactions} "
        f"D={low.static.n_dynamic} lyap_ok={low.lyap_ok:.0f}, {L} lanes T "
        f"400-800 K{note} | {verdict} {int(ok.sum())} | "
        f"negative TOF {int((out['tof'] < 0).sum())} | median iterations "
        f"{float(it.double().median()):.0f} max {int(it.max())} | host "
        f"syncs {syncs} | wall {wall:.3f} s, {L / wall:.1f} lanes/s, peak "
        f"memory {peak:.1f} MiB | launches {counts}")


def rescue_path(spec, conds, mask, device) -> dict:
    """Phase 10: the flagship lowered into its ABI bucket, through
    ``sweep_steady_state(..., opts=RESCUE_OPTS, abi=True,
    check_stability=True)``, twice (first and warm), with the lanes
    entering and leaving each rung of the ladder; then the LM rung alone
    on the fast pass's failed lanes; then the first :data:`SUBSET` lanes
    (a prefix, so that each failed lane's position in the failed list,
    hence its key, is the same) through the whole ladder on the CPU.
    Returns the launch counts of the first run."""
    import numpy as np
    import torch
    from pycatkin_tpu_torch import engine
    from pycatkin_tpu_torch.frontend import abi
    from pycatkin_tpu_torch.ops import prng
    from pycatkin_tpu_torch.parallel import batch
    from pycatkin_tpu_torch.solvers import newton
    L = len(conds.T)
    opts = newton.SolverOptions(**RESCUE_OPTS)
    rescue = batch._rescue
    rungs = []

    def logged(ds, c, res, o, strategy, **kw):
        n_in = int((~res.success).sum())
        out, n_left = rescue(ds, c, res, o, strategy, **kw)
        rungs.append(f"{newton.STRATEGY_NAMES[kw.get('code', 0)]} "
                     f"{n_in} -> {n_left}")
        return out, n_left

    run = lambda: batch.sweep_steady_state(
        spec, conds, mask, opts=opts, check_stability=True, abi=True,
        device=device)
    batch._rescue = logged
    try:
        torch.cuda.reset_peak_memory_stats()
        out, counts, syncs, wall = counted(run)
        peak = torch.cuda.max_memory_allocated() / 2**20
        ladder = list(rungs)
        _, _, _, warm = counted(run)
    finally:
        batch._rescue = rescue
    codes = out["lane_telemetry"][:, 3].cpu()
    hist = {newton.STRATEGY_NAMES[int(c)]: int((codes == c).sum())
            for c in torch.unique(codes)}
    ok = out["success"]
    att, it = out["attempts"].double(), out["iterations"].double()
    log(f"phase 10 rescue path: ABI flagship, {L} lanes T 400-800 K, "
        f"SolverOptions({RESCUE_OPTS}) | rungs (lanes in -> left): "
        f"{'; '.join(ladder)} | strategy codes {hist} | converged and "
        f"stable {int(ok.sum())} quarantined "
        f"{int(out['quarantined'].sum())} | attempts median "
        f"{float(att.median()):.0f} max {int(att.max())} | iterations "
        f"median {float(it.median()):.0f} max {int(it.max())} | wall first "
        f"{wall:.3f} s warm {warm:.3f} s, {L / warm:.1f} lanes/s, peak "
        f"memory {peak:.1f} MiB | host syncs {syncs} | launches {counts}")
    assert ladder, "the fast pass left no lane to rescue"
    assert all(counts[k] > 0 for k in ("lu_factor", "lu_solve",
                                       "factor_solve")), counts
    assert out["y"].shape == (L, spec.n_species)
    assert bool(torch.isfinite(out["y"][ok]).all())
    assert bool(torch.isfinite(out["tof"][ok]).all())

    # The LM rung on the card at full width, whatever polish left.
    low = abi.lower_spec(spec)
    ds = engine.bind(low, device)
    cp = engine.conditions_to(low.pad_conditions(conds), device)
    fast = engine.steady_state(ds, cp, opts=batch.fast_pass_opts(opts))
    n_failed = int((~fast.success).sum())
    (lm, n_left), lcounts, lsyncs, lwall = counted(
        lambda: rescue(ds, cp, fast, opts, "lm", n_failed=n_failed))
    log(f"phase 10 LM rung alone: {n_failed} failed lanes in, {n_left} "
        f"left | wall {lwall:.3f} s | host syncs {lsyncs} | launches "
        f"{lcounts}")
    assert n_failed > 0
    assert lcounts["lu_factor"] > 0 and lcounts["lu_solve"] > 0, lcounts
    # Its program on the first lanes, on the card and on the CPU: every
    # attempt fails, attempt 2 from a threefry draw on each device, so the
    # counts are the caps' and the best unconverged states carry the
    # check: within the envelope, or within twice the spread of the CPU's
    # own runs with T up, T down and kscale up one ulp (LM's march, on
    # squared condition numbers, moves them by more than the envelope).
    P = SUBSET
    pre = torch.arange(P, device=device)
    keys = prng.split(prng.prng_key(1, device), P)
    x0 = fast.x[pre][:, ds.dyn]
    got = engine.steady_state(ds, engine.lane_subset(cp, pre), x0=x0,
                              key=keys, opts=opts, strategy="lm")
    dsc = engine.bind(low, "cpu")
    sub = engine.lane_subset(type(cp)(*(f.cpu() for f in cp)), pre.cpu())
    lm_cpu = lambda c: engine.steady_state(dsc, c, x0=x0.cpu(),
                                           key=keys.cpu(), opts=opts,
                                           strategy="lm")
    want = lm_cpu(sub)
    for name in ("success", "attempts", "iterations", "rate_ok", "pos_ok",
                 "sums_ok"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), \
            f"phase 10 LM prefix parity: {name} differs"
    dx, frac = envelope_gap(got.x.cpu(), want.x)
    ulp = 1.0 + 2.0 ** -52
    spread = max(float((lm_cpu(c).x - want.x).abs().max()) for c in (
        sub._replace(T=sub.T * ulp), sub._replace(T=sub.T / ulp),
        sub._replace(kscale=sub.kscale * ulp)))
    assert frac <= 1.0 or dx <= 2.0 * spread, \
        f"phase 10 LM prefix parity: best states differ by {dx}, " \
        f"{frac:.3g} of the envelope, twice the one-ulp spread is " \
        f"{2.0 * spread}"
    # Where no attempt beats a seed's score the best state is the seed
    # itself, so the LM step is held apart: one attempt from the same
    # seeds, its own iterate by the same rule.
    def lm_attempt(dsx, c, x):
        kf, kr, _ = engine.rate_constants(dsx, c)
        cl = engine.closures(dsx, c, kf, kr)
        return newton._lm_attempt(cl.fscale, cl.jac, x, dsx.groups_dyn, opts)
    xg, _, kg, _, _ = lm_attempt(ds, engine.lane_subset(cp, pre), x0)
    xc, _, kc, _, _ = lm_attempt(dsc, sub, x0.cpu())
    assert torch.equal(kg.cpu(), kc), "phase 10 LM attempt: steps differ"
    moved = int((xc != x0.cpu()).any(dim=-1).sum())
    ax, afrac = envelope_gap(xg.cpu(), xc)
    aspread = max(float((lm_attempt(dsc, c, x0.cpu())[0] - xc).abs().max())
                  for c in (sub._replace(T=sub.T * ulp),
                            sub._replace(T=sub.T / ulp),
                            sub._replace(kscale=sub.kscale * ulp)))
    assert afrac <= 1.0 or ax <= 2.0 * aspread, \
        f"phase 10 LM attempt: iterates differ by {ax}, {afrac:.3g} of " \
        f"the envelope, twice the one-ulp spread is {2.0 * aspread}"
    log(f"phase 10 LM prefix parity: the LM program on the first {P} "
        f"failed lanes on the CPU: success, attempts "
        f"{sorted(set(want.attempts.tolist()))}, iterations and the verdict "
        f"tests equal; best unconverged states max gap {dx:.3e} ({frac:.3g} "
        f"of the envelope) vs the CPU's one-ulp spread {spread:.3e}; one "
        f"LM attempt from the same seeds: steps equal, {moved} of {P} "
        f"iterates moved, max gap {ax:.3e} ({afrac:.3g} of the envelope) "
        f"vs the CPU's one-ulp spread {aspread:.3e}")
    del fast, lm, cp, got

    # The prefix through the whole ladder on the CPU.
    P = SUBSET
    idx = np.arange(P)
    sub = type(conds)(*(np.asarray(f)[:P] for f in conds))
    rerun = lambda c: batch.sweep_steady_state(
        spec, c, mask, opts=opts, check_stability=True, abi=True,
        device="cpu")
    ref = rerun(sub)
    for name in ("success", "quarantined", "stable", "attempts"):
        assert torch.equal(out[name][:P].cpu(), ref[name]), \
            f"phase 10 CPU prefix parity: {name} differs"
    assert torch.equal(codes[:P], ref["lane_telemetry"][:, 3]), \
        "phase 10 CPU prefix parity: strategy codes differ"
    n_it = int((out["iterations"][:P].cpu() != ref["iterations"]).sum())
    fields = {"x": lambda o: o["y"], "tof": lambda o: o["tof"],
              "activity": lambda o: o["activity"]}
    gaps = {k: envelope_gap(g(out)[:P].cpu(), g(ref)) for k, g in
            fields.items()}
    held = "; ".join(f"{k} max gap {d:.3e} ({f:.3g} of the envelope)"
                     for k, (d, f) in gaps.items())
    if all(f <= 1.0 for _, f in gaps.values()):
        gate = "held to the envelope"
    else:
        # Where the ladder polishes a lane from a far start, the
        # reference moves its own converged states by more than the
        # envelope under a one-ulp change of its inputs (PERF.md §5).
        gate = one_ulp_gate("phase 10", spec, sub, rerun, ref, out, idx,
                            fields)
    log(f"phase 10 CPU prefix parity: the first {P} lanes through the "
        f"ladder on the CPU: success, quarantined, stable, attempts and "
        f"strategy codes equal; iteration counts differ on {n_it} lanes; "
        f"{held}; {gate}")

    # Converged rescued lanes pass the convergence test on the CPU.
    rescued = np.flatnonzero(((codes != 0) & ok.cpu()).numpy())
    if rescued.size:
        pick = rescued[np.linspace(0, rescued.size - 1,
                                   min(SUBSET, rescued.size)).round()
                       .astype(np.int64)]
        subr = type(conds)(*(np.asarray(f)[pick] for f in conds))
        rn = float(cpu_normalized_residual(
            spec, subr, out["y"][torch.as_tensor(pick, device=device)]
            .cpu()).max())
        log(f"phase 10 rescued lanes: {rescued.size} converged, "
            f"{pick.size} sampled, normalized residual on the CPU at most "
            f"{rn:.3g}")
        assert rn <= 1.0 + RESIDUAL_SLACK, rn
    return counts


def entry_path(spec, base, mask, device) -> None:
    """Phase 11: the flagship entry of ``__graft_entry__.py`` as written --
    per lane ``engine.steady_state`` with the default ``SolverOptions()``
    (five attempts) and key ``i`` of ``split(prng_key(0), L)``, then
    ``tof`` and ``activity_from_tof(|tof|)`` -- on the unpadded flagship,
    T 450-650 K; 256 lanes re-run on the CPU through the one-ulp gate of
    phase 3."""
    import numpy as np
    import torch
    from pycatkin_tpu_torch import engine
    from pycatkin_tpu_torch.ops import prng
    from pycatkin_tpu_torch.parallel import batch
    from pycatkin_tpu_torch.solvers import newton
    L = ENTRY_LANES
    conds = batch.broadcast_conditions(base, L)._replace(
        T=np.linspace(450.0, 650.0, L))
    keys = prng.split(prng.prng_key(0, device), L)

    def entry(c, k, dev):
        ds = engine.bind(spec, dev)
        ct = engine.conditions_to(c, dev)
        res = engine.steady_state(ds, ct, key=k, opts=newton.SolverOptions())
        t = engine.tof(ds, ct, res.x, torch.as_tensor(
            mask, dtype=torch.float64, device=dev))
        return res, t, engine.activity_from_tof(torch.abs(t), ct.T)

    out, counts, syncs, wall = counted(lambda: entry(conds, keys, device))
    _, _, _, warm = counted(lambda: entry(conds, keys, device))
    res = out[0]
    att = res.attempts.cpu()
    hist = {int(a): int((att == a).sum()) for a in torch.unique(att)}
    log(f"phase 11 flagship entry: engine.steady_state(SolverOptions()) "
        f"with split(prng_key(0), L) keys, synthetic(24, 32) unpadded, "
        f"{L} lanes T 450-650 K | converged {int(res.success.sum())} | "
        f"attempts {hist} | median iterations "
        f"{float(res.iterations.double().median()):.0f} max "
        f"{int(res.iterations.max())} | wall first {wall:.3f} s warm "
        f"{warm:.3f} s, {L / warm:.1f} lanes/s | host syncs {syncs} | "
        f"launches {counts}")
    assert set(counts.values()) == {0}, counts
    ok = res.success
    assert bool(torch.isfinite(res.x[ok]).all())
    assert bool(torch.isfinite(out[2][ok]).all())
    idx, sub = cpu_subset(conds)
    kc = keys[torch.as_tensor(idx, device=device)].cpu()
    rerun = lambda c: entry(c, kc, "cpu")
    ref = rerun(sub)
    for name in ("success", "attempts"):
        assert torch.equal(getattr(res, name)[idx].cpu(),
                           getattr(ref[0], name)), \
            f"phase 11 CPU subset parity: {name} differs"
    fields = {"x": lambda o: o[0].x, "tof": lambda o: o[1],
              "activity": lambda o: o[2]}
    gate = one_ulp_gate("phase 11", spec, sub, rerun, ref, out, idx, fields)
    log(f"phase 11 CPU parity: {SUBSET} lanes re-run on the CPU, and with "
        f"T up, T down, kscale up one ulp: success and attempts equal; "
        f"{gate}")


def transient_grid():
    """Phase 12's save grid: 0, then 19 points from 1e-10 to 1e8 s (the
    span of tests/test_ode_parity.py's DMTM check)."""
    import numpy as np
    return np.concatenate([[0.0], np.logspace(-10, 8, 19)])


def transient_cpu_rerun(shape, lanes: int, abi: bool, method: str,
                        miss=None, tail: bool = False):
    """Phase 12's CPU re-run of a transient path, in a worker process:
    :data:`TRANSIENT_SUBSET` evenly spaced lanes of the path's ``lanes``
    through the plain kernel versions, one intra-op thread at a lowered
    priority, or, for the re-run that ends the script (``tail``), two at
    the main process's. Returns ``(ys, ok, diagnostics, wall seconds,
    steps, start)`` as numpy arrays, a dict and numbers (``start``: the
    integration's ``time.perf_counter()``, a clock every process of the
    machine shares). Given ``miss`` (positions in the subset), runs
    instead those lanes with T up, T down and kscale up by one ulp
    (:func:`one_ulp_conditions`), as one batch of ``3 len(miss)``
    lanes, and returns their three ``ys``."""
    import numpy as np
    import torch
    torch.set_num_threads(2 if tail else 1)
    if not tail:
        # Yield the cores to the main process: the card's host-bound
        # steps. The longest re-run does not, so that it stays off the
        # script's end: at nice 10 on one thread it took 775-1,050 s on
        # an H100 machine's host (PERF.md).
        os.nice(10)
    if HERE not in sys.path:
        sys.path.insert(0, HERE)
    from pycatkin_tpu_torch.models.synthetic import synthetic_spec
    from pycatkin_tpu_torch.parallel import batch
    from pycatkin_tpu_torch.solvers import ode
    spec, base = synthetic_spec(*shape, seed=0)
    _, sub = cpu_subset(lanes_over_T(base, lanes), TRANSIENT_SUBSET)
    opts = ode.ODEOptions(method=method)
    if miss is not None:
        part = type(sub)(*(np.asarray(f)[miss] for f in sub))
        joint = type(sub)(*(np.concatenate(fs) for fs in
                            zip(*one_ulp_conditions(part))))
        ys, _ = batch.batch_transient(spec, joint, transient_grid(),
                                      opts=opts, abi=abi, device="cpu")
        return np.split(ys.numpy(), 3)
    ode.reset_counters()
    diag = {}
    t0 = time.perf_counter()
    ys, ok = batch.batch_transient(spec, sub, transient_grid(), opts=opts,
                                   abi=abi, device="cpu", diagnostics=diag)
    return (ys.numpy(), ok.numpy(), diag, time.perf_counter() - t0,
            ode.SYNCS["ode_active"], t0)


def large_cpu_rerun(use_abi: bool):
    """Phase 7's CPU re-run, in a worker process: :data:`LARGE_SUBSET`
    lanes of the large path (``fused_sweep``, or ``sweep_steady_state(
    abi=True, check_stability=False)``) through the plain versions, as
    they are and with T up, T down and kscale up by one ulp. It needs no
    result of the card, so it starts with the script. Returns the four
    outputs."""
    import torch
    torch.set_num_threads(2)
    os.nice(10)
    if HERE not in sys.path:
        sys.path.insert(0, HERE)
    from pycatkin_tpu_torch import engine
    from pycatkin_tpu_torch.models.synthetic import synthetic_spec
    from pycatkin_tpu_torch.parallel import batch
    spec, base = synthetic_spec(200, 200, seed=0)
    mask = engine.tof_mask_for(spec, [spec.rnames[-1]])
    _, sub = cpu_subset(lanes_over_T(base, LARGE_LANES), LARGE_SUBSET)
    if use_abi:
        rerun = lambda c: batch.sweep_steady_state(
            spec, c, mask, check_stability=False, abi=True, device="cpu")
    else:
        rerun = lambda c: batch.fused_sweep(spec, c, mask, device="cpu")
    return [rerun(c) for c in (sub,) + one_ulp_conditions(sub)]


def prefix(conds, size: int):
    """The first ``size`` lanes of ``conds`` (numpy)."""
    import numpy as np
    return type(conds)(*(np.asarray(f)[:size] for f in conds))


def same_bits(a, b) -> bool:
    """``torch.equal`` on the tensors' bits (a NaN equals itself)."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        iv = {8: torch.int64, 4: torch.int32}[a.element_size()]
        a, b = a.contiguous().view(iv), b.contiguous().view(iv)
    return torch.equal(a, b)


def moved_lanes(y, ref):
    """The lanes whose states lie outside :data:`Y_TOL` of ``ref``'s."""
    import torch
    return torch.any(torch.abs(y - ref) > Y_TOL["atol"]
                     + Y_TOL["rtol"] * torch.abs(ref), dim=-1)


def tier_cpu_rerun(label: str):
    """Phase 14's CPU re-run of the path ``label`` of :data:`TIER_PATHS`,
    in a worker process: its prefix through the plain versions under the
    f32-polish tier, as it is and with T up, T down and kscale up by one
    ulp (:func:`one_ulp_conditions`), then under float64. It needs no
    result of the card, so it is queued early. Returns the five result
    dicts."""
    import torch
    torch.set_num_threads(2)
    os.nice(10)
    if HERE not in sys.path:
        sys.path.insert(0, HERE)
    from pycatkin_tpu_torch import engine
    from pycatkin_tpu_torch.models.synthetic import synthetic_spec
    from pycatkin_tpu_torch.parallel import batch
    _, shape, L, use_abi, check, P, _ = next(p for p in TIER_PATHS
                                             if p[0] == label)
    spec, base = synthetic_spec(*shape, seed=0)
    mask = engine.tof_mask_for(spec, [spec.rnames[-1]])
    sub = prefix(lanes_over_T(base, L), P)
    run = lambda c, tier: batch.sweep_steady_state(
        spec, c, mask, check_stability=check, abi=use_abi, device="cpu",
        tier=tier)
    return [run(c, "f32-polish") for c in (sub,) + one_ulp_conditions(sub)] \
        + [run(sub, "f64")]


def tier_path(label, spec, conds, mask, use_abi, check, envelope, ref,
              ref_stats, job, device) -> dict:
    """Phase 14: one path under ``tier="f32-polish"``, first call and
    warm, against the same path's float64 run ``ref`` (``ref_stats``: its
    first and warm walls, host syncs and peak MiB). Gates: the verdict
    masks, quarantine and stability bitwise the float64 run's; float32
    ``lu_factor`` / ``lu_solve`` launches where the path's direction
    solves take a kernel (none on the unpadded flagship, whose n = 21
    takes Gauss-Jordan); the tier column 1 only on first-pass lanes; the
    CPU prefix (``job``, :func:`tier_cpu_rerun`) with the verdicts and
    the strategy and tier columns bitwise, states, TOF and activity
    within ``envelope`` else within twice the CPU's one-ulp spread (with
    the convergence test), and the lanes whose states leave
    :data:`Y_TOL` of the float64 ones the same on the card's prefix as
    on the CPU's. Two counts are printed, not refused, because the JAX
    package's tier shows them too (ROADMAP Queue C item 7): the lanes
    whose strategy column differs from the float64 run's (a float32
    first pass that fails where the float64 one converges, or the
    reverse, then the ladder) and the lanes whose float32 march ends on
    another stable steady state. Returns the launch counts of the first
    call."""
    import numpy as np
    import torch
    from pycatkin_tpu_torch.parallel import batch
    L = len(conds.T)
    run = lambda: batch.sweep_steady_state(
        spec, conds, mask, check_stability=check, abi=use_abi,
        device=device, tier="f32-polish")
    torch.cuda.reset_peak_memory_stats()
    out, counts, syncs, wall = counted(run)
    peak = torch.cuda.max_memory_allocated() / 2**20
    _, _, wsyncs, warm = counted(run)
    names = [n for n in ("success", "quarantined", "stable", "rate_ok",
                         "pos_ok", "sums_ok") if n in ref]
    tel, rtel = out["lane_telemetry"], ref["lane_telemetry"]
    differ = {n: int((out[n] != ref[n]).sum()) for n in names}
    n_strategy = int((tel[:, 3] != rtel[:, 3]).sum())
    moved = moved_lanes(out["y"], ref["y"])
    ok = out["success"]
    f1, w1, s1, p1 = ref_stats
    log(f"phase 14 tier {label}: f32-polish, {L} lanes | lanes whose "
        f"verdicts differ from the float64 run: {differ}, whose strategy "
        f"column differs: {n_strategy} | converged "
        f"{int(ok.sum())}, tier code 1 on {int((tel[:, 4] == 1).sum())} "
        f"lanes | states outside rtol 5e-2 / atol 1e-12 of the float64 "
        f"states on {int(moved.sum())} lanes | wall first {wall:.3f} s "
        f"warm {warm:.3f} s ({L / warm:.1f} lanes/s) vs float64 first "
        f"{f1:.3f} s warm {w1:.3f} s ({L / w1:.1f} lanes/s) | host syncs "
        f"{syncs} (warm {wsyncs}) vs {s1} | peak memory {peak:.1f} MiB vs "
        f"{p1:.1f} MiB | launches {counts}")
    assert not any(differ.values()), (label, differ)
    if use_abi:
        assert counts["lu_factor_f32"] > 0 and counts["lu_solve_f32"] > 0, \
            counts
    else:
        assert set(counts.values()) == {0}, counts
    assert bool(((tel[:, 4] == 0) | (tel[:, 3] == 0)).all())
    assert bool(torch.isfinite(out["y"][ok]).all())

    runs = job.get(timeout=max(TRANSIENT_GATE_BY
                               - (time.perf_counter() - START), 1.0))
    cpu, ulps, cpu64 = runs[0], runs[1:4], runs[4]
    P = len(cpu["y"])
    idx = np.arange(P)
    sub = prefix(conds, P)
    for n in names:
        assert torch.equal(out[n][:P].cpu(), cpu[n]), \
            f"phase 14 {label} CPU prefix parity: {n} differs"
    assert torch.equal(tel[:P, 3:].cpu(), cpu["lane_telemetry"][:, 3:]), \
        f"phase 14 {label} CPU prefix parity: telemetry columns differ"
    fields = {"x": lambda o: o["y"], "tof": lambda o: o["tof"],
              "activity": lambda o: o["activity"]}
    gaps = {k: envelope_gap(g(out)[:P].cpu(), g(cpu), envelope or ENVELOPE)
            for k, g in fields.items()}
    held = "; ".join(f"{k} max gap {d:.3e} ({f:.3g} of the envelope)"
                     for k, (d, f) in gaps.items())
    if envelope is not None and all(f <= 1.0 for _, f in gaps.values()):
        gate = "held to the envelope"
    else:
        gate = one_ulp_gate(f"phase 14 {label}", spec, sub, None, cpu, out,
                            idx, fields, runs=ulps)
    cmoved = moved_lanes(cpu["y"], cpu64["y"])
    assert torch.equal(moved[:P].cpu(), cmoved), \
        f"phase 14 {label}: the lanes off the float64 states differ " \
        f"between the card ({int(moved[:P].sum())}) and the CPU " \
        f"({int(cmoved.sum())})"
    log(f"phase 14 tier {label} CPU parity: the first {P} lanes under "
        f"f32-polish on the CPU through the plain versions, and with T up, "
        f"T down, kscale up one ulp: {', '.join(names)}, strategy and tier "
        f"columns equal; {held}; {gate}; lanes off the float64 states "
        f"{int(cmoved.sum())} on the CPU, the same on the card")
    return counts


def pack_phase(device) -> dict:
    """Phase 15: four same-bucket tenants of ``PACK_LANES`` lanes each, T
    400-800 K, TOF, ``check_stability=True``, under both tiers: each
    tenant's solo ``sweep_steady_state(..., abi=True)``, then
    ``packed_sweep_steady_state`` first and warm; every tenant's dict
    equal to its solo one key by key (bits). Prints the packed fast
    pass's ``lu_factor`` launches and host syncs beside each solo sweep's
    and the packed wall beside the sum of the solo walls. Then a K = 3
    pack of :data:`PACK3_LANES` lanes a tenant. Returns the packed runs'
    launch counts by tier."""
    import torch
    from pycatkin_tpu_torch import engine
    from pycatkin_tpu_torch.frontend import abi
    from pycatkin_tpu_torch.models.synthetic import \
        synthetic_system_for_bucket
    from pycatkin_tpu_torch.parallel import batch

    def tenants(shape):
        kw = {} if shape is None else dict(n_species=shape[0],
                                           n_reactions=shape[1])
        out = []
        for seed in PACK_SEEDS:
            sysm = synthetic_system_for_bucket(128, seed=seed, **kw)
            out.append((sysm.build(strict=False).spec, sysm.conditions()))
        return out

    ts = tenants(None)
    Ds = [abi.lower_spec(sp).static.n_dynamic for sp, _ in ts]
    which = f"synthetic_system_for_bucket(128, seed={list(PACK_SEEDS)})"
    if set(Ds) != {32}:
        which = (f"synthetic_system_for_bucket(128) at its default shape "
                 f"lowers seeds {list(PACK_SEEDS)} to D = {Ds}; taken: "
                 f"seeds {list(PACK_SEEDS)} at n_species=24, "
                 f"n_reactions=32 (the flagship's shape, bucket 128)")
        ts = tenants((24, 32))
    lows = [abi.lower_spec(sp) for sp, _ in ts]
    assert len({low.static for low in lows}) == 1, [l.static for l in lows]
    st = lows[0].static
    assert st.n_dynamic == 32, st
    specs = [sp for sp, _ in ts]
    masks = [engine.tof_mask_for(sp, [sp.rnames[-1]]) for sp in specs]
    K = len(specs)
    by_tier = {}
    for tier in ("f64", "f32-polish"):
        conds = [lanes_over_T(b, PACK_LANES) for _, b in ts]
        solo = [counted(lambda sp=sp, c=c, m=m: batch.sweep_steady_state(
            sp, c, m, check_stability=True, abi=True, device=device,
            tier=tier)) for sp, c, m in zip(specs, conds, masks)]
        run = lambda: batch.packed_sweep_steady_state(
            specs, conds, masks, check_stability=True, device=device,
            tier=tier)
        torch.cuda.reset_peak_memory_stats()
        packed, pcounts, psyncs, pwall = counted(run)
        ppeak = torch.cuda.max_memory_allocated() / 2**20
        _, _, _, pwarm = counted(run)
        for k, ((so, _, _, _), pa) in enumerate(zip(solo, packed)):
            assert sorted(so) == sorted(pa), (tier, k)
            bad = [key for key in so if not same_bits(so[key], pa[key])]
            assert not bad, f"phase 15 {tier} tenant {k}: {bad} differ " \
                f"from its solo sweep"
        lu = "lu_factor" + ("_f32" if tier == "f32-polish" else "")
        clean = all(bool(so["success"].all())
                    and bool((so["lane_telemetry"][:, 3] == 0).all())
                    for so, _, _, _ in solo)
        solo_lu = [c[lu] for _, c, _, _ in solo]
        solo_syncs = [sy for _, _, sy, _ in solo]
        solo_wall = sum(w for _, _, _, w in solo)
        log(f"phase 15 packed {tier}: {which}; S={st.n_species} "
            f"R={st.n_reactions} D={st.n_dynamic}, {K} tenants x "
            f"{PACK_LANES} lanes, T 400-800 K | every tenant equal to its "
            f"solo sweep key by key (bits) | converged and stable "
            f"{[int(p['success'].sum()) for p in packed]}, all first pass "
            f"{clean} | {lu} launches packed {pcounts[lu]} vs solo "
            f"{solo_lu} | host syncs packed {psyncs} vs solo {solo_syncs} "
            f"| wall packed first {pwall:.3f} s warm {pwarm:.3f} s "
            f"({K * PACK_LANES / pwarm:.1f} lanes/s) vs the four solo "
            f"sweeps {solo_wall:.3f} s | peak memory packed {ppeak:.1f} "
            f"MiB | launches packed {pcounts}")
        assert pcounts[lu] > 0
        if clean:
            assert pcounts[lu] == max(solo_lu), (pcounts[lu], solo_lu)
            assert psyncs == max(solo_syncs), (psyncs, solo_syncs)
        by_tier[tier] = pcounts
        del packed, solo
        conds3 = [lanes_over_T(b, PACK3_LANES) for _, b in ts[:3]]
        solo3 = [batch.sweep_steady_state(sp, c, m, check_stability=True,
                                          abi=True, device=device,
                                          tier=tier)
                 for sp, c, m in zip(specs, conds3, masks)]
        pack3 = batch.packed_sweep_steady_state(
            specs[:3], conds3, masks[:3], check_stability=True,
            device=device, tier=tier)
        for k, (so, pa) in enumerate(zip(solo3, pack3)):
            bad = [key for key in so if not same_bits(so[key], pa[key])]
            assert not bad, f"phase 15 K=3 {tier} tenant {k}: {bad}"
        log(f"phase 15 packed {tier} K=3 (tenant bucket "
            f"{abi.pack_lowered(lows[:3]).k_bucket}): 3 x {PACK3_LANES} "
            f"lanes, every tenant equal to its solo sweep key by key "
            f"(bits)")
    return by_tier


def wire_system(sim, device):
    """``sim`` as the server reads it: its wire form
    (``utils.io.system_to_dict``) loaded back on ``device``."""
    import tempfile
    from pycatkin_tpu_torch.frontend.loader import read_from_input_file
    from pycatkin_tpu_torch.utils.io import system_to_dict
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "mechanism.json")
        with open(path, "w") as fh:
            json.dump(system_to_dict(sim), fh)
        return read_from_input_file(path, device=device)


def solo_answer(sim, T, save_ts, device, tof_terms=None) -> str:
    """``canonical_answer`` of the server's response to one request,
    from a solo call on ``device`` at the coalescer's options (the
    mechanism read back from its wire form)."""
    import numpy as np
    from pycatkin_tpu_torch import engine
    from pycatkin_tpu_torch.parallel import batch
    from pycatkin_tpu_torch.serve.protocol import canonical_answer, jsonable
    from pycatkin_tpu_torch.serve.server import SUMMARY_KEYS
    w = wire_system(sim, device)
    spec = w.spec
    conds = batch.stack_conditions([w.conditions(T=t, p=1.0e5) for t in T])
    if save_ts is None:
        mask = (engine.tof_mask_for(spec, tof_terms) if tof_terms
                else None)
        out = batch.sweep_steady_state(spec, conds, mask, abi=True,
                                       device=device)
        host = {k: v.cpu().numpy() for k, v in out.items()}
        result = {k: host[k] for k in SUMMARY_KEYS if k in host}
        q = host["quarantined"]
    else:
        ys, ok = batch.batch_transient(spec, conds, save_ts, abi=True,
                                       device=device)
        ys = ys.cpu().numpy()
        result = {"ok": ok.cpu().numpy(), "endpoint": ys[:, -1, :]}
        q = ~np.isfinite(ys[:, -1, :]).all(axis=-1)
    return canonical_answer({
        "result": jsonable(result), "lanes": len(T),
        "quarantine": {"count": int(q.sum()),
                       "lanes": np.nonzero(q)[0].tolist()}})


def serve_phase(device) -> dict:
    """Phase 16 (see the module doc). Returns the launch counts by
    ``(name, n, lanes)`` of each serve path: ``serve`` (16a's soak),
    ``serve_transient`` and ``serve_full`` (16b)."""
    import asyncio
    import numpy as np
    from pycatkin_tpu_torch import engine
    from pycatkin_tpu_torch.frontend import abi
    from pycatkin_tpu_torch.models.synthetic import (
        synthetic_system, synthetic_system_for_bucket)
    from pycatkin_tpu_torch.ops import cuda_linalg as cl
    from pycatkin_tpu_torch.parallel import batch
    from pycatkin_tpu_torch.serve import (ServeConfig, SweepServer,
                                          TcpSweepClient)
    from pycatkin_tpu_torch.serve.client import sweep_payload
    from pycatkin_tpu_torch.serve.protocol import canonical_answer, jsonable
    from pycatkin_tpu_torch.serve.server import SUMMARY_KEYS
    from pycatkin_tpu_torch.serve.soak import check_soak_record, run_soak
    from pycatkin_tpu_torch.utils.io import system_to_dict

    # -- 16a: the soak, sweeps only -----------------------------------------
    samples, timing = {}, []

    def keep(i, sim, T, save_ts, resp):
        if resp.get("ok"):
            timing.append((resp["timing"]["queue_s"],
                           resp["timing"]["solve_s"]))
        if i < SERVE_AUDIT:
            samples[i] = (sim, T, save_ts, resp)

    rec, counts, syncs, wall = counted(lambda: run_soak(
        n_requests=SERVE_REQUESTS, transport="tcp", device=str(device),
        on_response=keep))
    by_shape = dict(cl.LAUNCHES_BY_SHAPE)
    problems = check_soak_record(rec)
    sv = rec["serve"]
    q = np.array(timing)
    log(f"phase 16a serve soak: TCP, {rec['n_requests']} requests "
        f"({rec['n_transient']} transient) over buckets {rec['buckets']}, "
        f"{rec['lanes']} lanes each, "
        f"{rec['mechs_per_bucket']} mechanisms a bucket, max_occupancy "
        f"{rec['max_occupancy']}, concurrency {rec['concurrency']} | ok "
        f"{rec['n_ok']} failed {rec['n_failed']} schema violations "
        f"{rec['schema_violations']} | warm-up {rec['warmup']} | "
        f"measured: p50 {sv['p50_s']:.4f} s p99 {sv['p99_s']:.4f} s mean "
        f"{sv['mean_s']:.4f} s, {sv['throughput_rps']:.2f} requests/s, "
        f"{sv['throughput_rps'] * rec['lanes']:.1f} lanes/s | queue_s "
        f"mean {q[:, 0].mean():.4f} s vs solve_s mean {q[:, 1].mean():.4f} "
        f"s | flushes {sv['flushes']} ({sv['flushes_after_warm']} after "
        f"warm-up), mean occupancy {sv['mean_occupancy']:.3f}, zero-compile "
        f"rate {sv['zero_compile_rate']}, drain burst ok "
        f"{sv['drain_burst_ok']} | soak wall {rec['wall_s']:.1f} s (the "
        f"whole run {wall:.1f} s) | host syncs {syncs} | launches {counts} "
        f"by (kernel, n, lanes) {sorted(by_shape.items())}")
    assert not problems, f"phase 16a: check_soak_record: {problems}"
    assert counts["lu_factor"] > 0 and counts["lu_solve"] > 0, counts
    assert len(samples) == SERVE_AUDIT, sorted(samples)
    t0 = time.perf_counter()
    for i in sorted(samples):
        sim, T, save_ts, resp = samples[i]
        assert canonical_answer(resp) == solo_answer(sim, T, save_ts,
                                                     device), \
            f"phase 16a: measured answer {i} differs from its solo call"
    log(f"phase 16a serve audit: the first {SERVE_AUDIT} measured answers "
        f"re-run as solo calls on the card "
        f"({time.perf_counter() - t0:.1f} s): canonical_answer "
        f"byte-identical")

    # -- 16b: transients, then full width, each through its own server ---
    def through_server(requests, max_occupancy=None):
        async def go():
            srv = await SweepServer(ServeConfig(
                device=str(device), max_occupancy=max_occupancy)).start()
            cli = await TcpSweepClient("127.0.0.1", srv.port).connect()
            try:
                return await requests(cli)
            finally:
                await cli.close()
                await srv.drain()
        return counted(lambda: asyncio.run(go()))

    tsims = [synthetic_system_for_bucket(b, seed=sd, device=str(device))
             for b, sd in SERVE_TRANSIENTS]
    grid = [0.0] + [float(t) for t in np.logspace(-9, 0, 13)]
    tT = [480.0, 493.0, 507.0, 520.0]

    async def transients(cli):
        t0 = time.perf_counter()
        trs = await asyncio.gather(*(
            cli.transient(system_to_dict(s), tT, grid, wait_budget_s=1.0)
            for s in tsims))
        return trs, time.perf_counter() - t0

    (trs, tw), tcounts, tsyncs, _ = through_server(transients)
    tby_shape = dict(cl.LAUNCHES_BY_SHAPE)
    assert all(r.get("ok") for r in trs), [r.get("error") for r in trs]
    packs = [r["pack"]["tenants"] for r in trs]
    assert packs == [2, 2, 1], packs
    t0 = time.perf_counter()
    for s_, r in zip(tsims, trs):
        assert canonical_answer(r) == solo_answer(s_, tT, grid, device), \
            "phase 16b: a served transient differs from its solo call"
    log(f"phase 16b serve transients: {len(tsims)} requests (bucket, seed) "
        f"{list(SERVE_TRANSIENTS)}, {len(tT)} lanes each, the soak's grid "
        f"0, 1e-9 .. 1 s, over TCP: packs {packs}, {tw:.3f} s round trip, "
        f"timing {[r['timing'] for r in trs]}; each byte-identical to its "
        f"solo batch_transient(abi=True) on the card "
        f"({time.perf_counter() - t0:.1f} s of solo runs) | host syncs "
        f"{tsyncs} | launches {tcounts} by (kernel, n, lanes) "
        f"{sorted(tby_shape.items())}")
    assert tcounts["lu_factor"] > 0 and tcounts["lu_solve"] > 0, tcounts

    fsim = synthetic_system(24, 32, seed=0, device=str(device))
    fT = [float(t) for t in np.linspace(400.0, 800.0, FLAGSHIP_LANES)]
    fterm = [fsim.spec.rnames[-1]]
    psims = [synthetic_system_for_bucket(128, seed=sd, n_species=24,
                                         n_reactions=32, device=str(device))
             for sd in PACK_SEEDS]
    pT = [float(t) for t in np.linspace(400.0, 800.0, PACK_LANES)]

    async def full_width(cli):
        t0 = time.perf_counter()
        one = await cli.sweep(system_to_dict(fsim), fT, tof_terms=fterm,
                              wait_budget_s=0.0, deadline_class="batch")
        t1 = time.perf_counter()
        four = await asyncio.gather(*(
            cli.request(sweep_payload(
                system_to_dict(s), pT, tof_terms=[s.spec.rnames[-1]],
                wait_budget_s=30.0, deadline_class="batch",
                req_id=f"tenant{k}"))
            for k, s in enumerate(psims)))
        return one, four, t1 - t0, time.perf_counter() - t1

    (one, four, w1, w4), fcounts, fsyncs, fwall = through_server(
        full_width, max_occupancy=len(PACK_SEEDS))
    fby_shape = dict(cl.LAUNCHES_BY_SHAPE)
    assert one.get("ok"), one.get("error")
    assert all(r.get("ok") for r in four), [r.get("error") for r in four]
    t0 = time.perf_counter()
    want = solo_answer(fsim, fT, None, device, tof_terms=fterm)
    assert canonical_answer(one) == want, \
        "phase 16b: the 65,536-lane answer differs from the direct sweep"
    ws = [wire_system(s, device) for s in psims]
    pconds = [batch.stack_conditions([w.conditions(T=t, p=1.0e5)
                                      for t in pT]) for w in ws]
    pmasks = [engine.tof_mask_for(w.spec, [w.spec.rnames[-1]]) for w in ws]
    direct = batch.packed_sweep_steady_state(
        [w.spec for w in ws], pconds, pmasks, device=device)
    for k, (resp, out) in enumerate(zip(four, direct)):
        assert resp["pack"]["tenants"] == len(PACK_SEEDS), resp["pack"]
        host = {n: v.cpu().numpy() for n, v in out.items()}
        qd = host["quarantined"]
        ref = canonical_answer({
            "result": jsonable({n: host[n] for n in SUMMARY_KEYS
                                if n in host}),
            "lanes": len(pT),
            "quarantine": {"count": int(qd.sum()),
                           "lanes": np.nonzero(qd)[0].tolist()}})
        assert canonical_answer(resp) == ref, \
            f"phase 16b: tenant {k} differs from the direct packed sweep"
    st = abi.lower_spec(fsim.spec).static
    log(f"phase 16b serve full width: one {FLAGSHIP_LANES}-lane sweep "
        f"request of the ABI flagship (S={st.n_species} R={st.n_reactions} "
        f"D={st.n_dynamic}, TOF) {w1:.3f} s round trip "
        f"({FLAGSHIP_LANES / w1:.1f} lanes/s; timing {one['timing']}), "
        f"byte-identical to a direct sweep_steady_state(abi=True) | "
        f"{len(PACK_SEEDS)} tenants x {PACK_LANES} lanes submitted together "
        f"{w4:.3f} s round trip ({len(PACK_SEEDS) * PACK_LANES / w4:.1f} "
        f"lanes/s), one packed flush (pack {four[0]['pack']}), each "
        f"byte-identical to a direct packed_sweep_steady_state of the four "
        f"({time.perf_counter() - t0:.1f} s of direct runs) | host syncs "
        f"{fsyncs} | wall {fwall:.1f} s | launches {fcounts} by (kernel, "
        f"n, lanes) {sorted(fby_shape.items())}")
    assert fcounts["lu_factor"] > 0 and fcounts["lu_solve"] > 0, fcounts

    return {"serve": by_shape, "serve_transient": tby_shape,
            "serve_full": fby_shape}


def same_arrays(a: dict, b: dict) -> bool:
    """Two result dicts of host arrays with the same keys and the same
    bits (NaN where NaN)."""
    import numpy as np
    return sorted(a) == sorted(b) and all(
        np.array_equal(a[k], b[k], equal_nan=True) for k in a)


def robust_phase(spec, conds, mask, aout, esdirk, esdirk_counts,
                 device) -> dict:
    """Phase 17 (see the module doc). ``conds`` / ``mask``: the ABI
    flagship's 65,536 lanes and TOF mask (phase 3's); ``aout``: phase 5's
    unchunked sweep of them; ``esdirk``: phase 12's ESDIRK4 path as
    ``(spec, conds, grid, opts, ys, ok)``, and ``esdirk_counts`` its
    launches. Returns the launch counts of
    ``chunked_abi`` (17a's undisturbed run) by ``(name, n, lanes)`` and
    of ``transient_chunked`` (17c) by name."""
    import tempfile
    import numpy as np
    import torch
    from pycatkin_tpu_torch.models.synthetic import synthetic_system
    from pycatkin_tpu_torch.obs import metrics
    from pycatkin_tpu_torch.ops import cuda_linalg as cl
    from pycatkin_tpu_torch.parallel import batch, dispatch
    from pycatkin_tpu_torch.robustness import (
        DegradationPolicy, FaultPlan, chunked_sweep_steady_state,
        fault_scope, format_failure_report, run_elastic,
        sweep_failure_report)

    rungs = lambda: dict(metrics.counter("pycatkin_ladder_rung_total")
                         .values())
    L = len(conds.T)
    n_chunks = -(-L // ROBUST_CHUNK)
    kw = dict(chunk=ROBUST_CHUNK, tof_mask=mask, check_stability=True,
              abi=True, device=device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_17_") as td:
        # -- 17a: undisturbed, faulted, resumed ---------------------------
        r0 = rungs()
        (out1, rep1), counts1, syncs1, w1 = counted(
            lambda: chunked_sweep_steady_state(
                spec, conds, journal=os.path.join(td, "j1"), **kw))
        by_shape = dict(cl.LAUNCHES_BY_SHAPE)
        assert rungs() == r0, ("phase 17a: a ladder rung fired on the "
                               "undisturbed run", r0, rungs())
        assert rep1["events"] == [] and not (
            rep1["degraded"] or rep1["salvaged"] or rep1["quarantined"]), \
            rep1
        assert all(counts1[k] > 0 for k in cl.LAUNCHES), counts1
        ok1 = out1["success"]
        assert out1["y"].shape == (L, spec.n_species)
        assert bool(np.isfinite(out1["y"][ok1]).all())
        whole = {k: aout[k].cpu().numpy() for k in ("success", "y")}
        both = ok1 & whole["success"]
        dy = float(np.abs(out1["y"][both] - whole["y"][both]).max())
        log(f"phase 17a chunked ABI flagship: {L} lanes as {n_chunks} "
            f"journaled chunks of {ROBUST_CHUNK}, check_stability, TOF | "
            f"converged {int(ok1.sum())} (unchunked phase 5: "
            f"{int(whole['success'].sum())}; max |dy| on lanes both "
            f"converged {dy:.3e}) | no ladder rung fired | host syncs "
            f"{syncs1} | wall {w1:.3f} s | launches {counts1} by (kernel, "
            f"n, lanes) "
            f"{sorted(by_shape.items())}")
        plan = FaultPlan([
            {"site": "chunk:1", "kind": "transient", "times": 1},
            {"site": "chunk:2", "kind": "permanent", "times": None},
            # The sweep's first-pass label: its third occurrence is chunk
            # 3's (chunk 2 never reaches its sweep).
            {"site": "batched steady solve", "kind": "nan", "index": 2,
             "lanes": list(ROBUST_NAN_LANES), "times": 1},
            {"site": "rescue*", "kind": "nan", "times": None}])
        policy = DegradationPolicy(host_fallback=False, base_delay_s=0.01,
                                   max_delay_s=0.05)
        t0 = time.perf_counter()
        with fault_scope(plan):
            out2, rep2 = chunked_sweep_steady_state(
                spec, conds, journal=os.path.join(td, "j2"), policy=policy,
                **kw)
        w2 = time.perf_counter() - t0
        fired = rungs()
        assert rep2["salvaged"] == [2], rep2["salvaged"]
        assert 3 in rep2["quarantined"], rep2["quarantined"]
        lo = 3 * ROBUST_CHUNK
        bad = [lo + i for i in ROBUST_NAN_LANES]
        assert bool(out2["quarantined"][bad].all())
        assert not bool(out2["success"][bad].any())
        assert [e["kind"] for e in plan.log][:2] == ["transient",
                                                     "permanent"]
        forensic = sweep_failure_report(out2, conds=conds,
                                        events=rep2["events"],
                                        device=device)
        assert set(bad) <= set(forensic["quarantined_lanes"])
        first = format_failure_report(forensic).splitlines()[0]
        t0 = time.perf_counter()
        out3, rep3 = chunked_sweep_steady_state(
            spec, conds, journal=os.path.join(td, "j2"), resume=True, **kw)
        w3 = time.perf_counter() - t0
        redo = set(rep2["salvaged"]) | set(rep2["quarantined"])
        assert rep3["reused"] == sorted(set(range(n_chunks)) - redo), rep3
        assert not (rep3["salvaged"] or rep3["quarantined"]), rep3
        assert same_arrays(out3, out1), \
            "phase 17a: the resumed sweep differs from the undisturbed one"
        log(f"phase 17a faulted and resumed: plan fired "
            f"{[(e['site'], e['kind']) for e in plan.log]} | report: "
            f"reused {rep2['reused']} degraded {rep2['degraded']} salvaged "
            f"{rep2['salvaged']} quarantined {rep2['quarantined']}, "
            f"{rep2['n_failed_lanes']} failed lanes, rungs "
            f"{ {k: v - r0.get(k, 0.0) for k, v in fired.items()} } | "
            f"forensics: {first} | wall {w2:.3f} s | resume: reused "
            f"{rep3['reused']}, re-solved {sorted(redo)}, wall {w3:.3f} s, "
            f"equal to the undisturbed run bit for bit")

        # -- 17b: elastic and static modes ---------------------------------
        sim = synthetic_system(24, 32, seed=0, device=device)
        ce = lanes_over_T(sim.conditions(), ELASTIC_LANES)
        terms = [spec.rnames[-1]]
        ekw = dict(tof_mask=mask, check_stability=True, abi=True,
                   device=device)
        # The static run's workers start beside the elastic run's: both
        # are cold starts on the one card, which overlap.
        from concurrent.futures import ThreadPoolExecutor
        pool_s = ThreadPoolExecutor(max_workers=1)

        def static_run():
            t = time.perf_counter()
            got = dispatch.dispatch_sweep(
                sim, ce, n_workers=2, mode="static", tof_terms=terms,
                check_stability=True, abi=True, device=device,
                timeout=300.0)
            return got, time.perf_counter() - t

        static_job = pool_s.submit(static_run)
        t0 = time.perf_counter()
        eout, erep = run_elastic(
            sim, ce, n_workers=2, chunk=ELASTIC_CHUNK,
            work_dir=os.path.join(td, "elastic"), tof_terms=terms,
            check_stability=True, abi=True, device=device, ttl_s=60.0,
            heartbeat_s=2.0,
            restart_base_s=0.2, restart_max_s=1.0, timeout=300.0,
            fault_plan={"specs": [{"site": "worker:0",
                                   "kind": "worker-crash", "times": 1}],
                        "state_dir": os.path.join(td, "faultstate")})
        we = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref_e, _ = chunked_sweep_steady_state(
            sim.spec, ce, chunk=ELASTIC_CHUNK, pipeline=True, **ekw)
        wr = time.perf_counter() - t0
        assert same_arrays(eout, ref_e), \
            "phase 17b: the elastic sweep differs from the in-process one"
        assert erep["restarts"] >= 1, erep["restarts"]
        sout, wst = static_job.result()
        pool_s.shutdown()
        ref_s, _ = chunked_sweep_steady_state(
            sim.spec, ce, chunk=-(-ELASTIC_LANES // 2), **ekw)
        assert same_arrays(sout, ref_s), \
            "phase 17b: the static sweep differs from the in-process one"
        log(f"phase 17b elastic: {ELASTIC_LANES} lanes, chunk "
            f"{ELASTIC_CHUNK}, 2 workers on the card, worker-crash at "
            f"worker:0 | restarts {erep['restarts']} exits "
            f"{[(e['worker'], e['kind']) for e in erep['exits']]} leases "
            f"{erep['leases']} | wall {we:.3f} s (in-process chunked, "
            f"pipelined, {wr:.3f} s) | equal to the in-process chunked "
            f"sweep bit for bit | static, beside it: 2 worker blocks, "
            f"wall {wst:.3f} s, equal to the in-process sweep of its "
            f"blocks bit for bit")

    # -- 17c: the chunked transient -------------------------------------
    tspec, tconds, grid, opts, ys, ok = esdirk
    (ys2, ok2), tcounts, tsyncs, wt = counted(lambda: batch.batch_transient(
        tspec, tconds, grid, opts=opts, abi=True, device=device,
        fused=False, force_chunking=True))
    assert torch.equal(ys2, ys) and torch.equal(ok2, ok), \
        "phase 17c: the chunked transient differs from the fused one"
    assert tcounts == esdirk_counts, ("phase 17c: launches differ from "
                                      "phase 12's", tcounts, esdirk_counts)
    log(f"phase 17c chunked transient: ESDIRK4 abi=True, {len(tconds.T)} "
        f"lanes, {len(grid)} save times in blocks of 8 | equal to phase "
        f"12's fused result bit for bit, with its launches | host syncs "
        f"{tsyncs} | wall "
        f"{wt:.3f} s | launches {tcounts}")
    return by_shape, tcounts


def fleet_phase() -> dict:
    """Phase 18 (see the module doc): the chaos drill on the card.
    Returns the replicas' launch counts by ``(name, n, lanes)``, summed
    over the routable replicas' own counters (kernels-line path
    ``serve_fleet``); a killed incarnation's launches die with it, so
    the sum is a floor."""
    import torch
    from pycatkin_tpu_torch.ops import cuda_linalg as cl
    from pycatkin_tpu_torch.serve.soak import (check_chaos_record,
                                               run_chaos_drill)

    # The replicas' CUDA contexts share the card with this process's
    # cached blocks from the earlier phases.
    torch.cuda.empty_cache()
    rec, counts, syncs, wall = counted(lambda: run_chaos_drill(
        device="cuda", time_limit_s=FLEET_LIMIT_S, **FLEET_DRILL))
    base_shape = dict(cl.LAUNCHES_BY_SHAPE)
    by_shape = {(name, n, lanes): c
                for name, n, lanes, c in rec["launches"]["replicas"]}
    per_replica = {k: sum(r[3] for r in (v or {}).get("launches") or [])
                   for k, v in rec["replica_stats"].items()}
    problems = check_chaos_record(rec)
    router, durable = rec["router"], rec["durable"]
    dups = router["duplicates"]
    rs = rec["replica_stats"]
    log(f"phase 18 fleet: chaos drill on the card, {rec['n_requests']} "
        f"requests of {rec['lanes']} lanes (bucket {rec['bucket']}, "
        f"{rec['mechs']} mechanisms, max_occupancy "
        f"{rec['max_occupancy']}), {rec['n_replicas']} replica processes, "
        f"{rec['kills_fired']} of {rec['kill']} replicas and "
        f"{durable['router_kills_fired']} router killed | ok "
        f"{rec['n_ok']} lost {router['lost']} bitwise mismatches "
        f"{router['bitwise_mismatches']} | availability "
        f"{router['availability']} retries {router['retries']} hedges "
        f"{router['hedges']} failovers {router['failovers']} failover p99 "
        f"{router['failover_p99_s']} s | duplicates suppressed "
        f"{dups['suppressed']} identical {dups['identical']} mismatched "
        f"{dups['mismatched']} | incarnations {rec['incarnations']}, "
        f"router {durable['router_incarnations']} (recovery "
        f"{durable['router_recovery_s']} s, journal replay "
        f"{durable['journal_replay_s']} s of {durable['replay']}), "
        f"journaled answers off the baseline "
        f"{len(durable['result_fetch_bad'])}, duplicates served "
        f"{durable['duplicates_served']} coalesced {durable['coalesced']}, "
        f"client reconnects {durable['client_reconnects']} acks "
        f"{durable['client_acks']} | replica flushes (with a kernel "
        f"library build or load) "
        f"{ {k: (v['flushes'], v['flushes_with_compiles']) for k, v in rs.items()} } "
        f"| walls {rec['walls']} drill {rec['wall_s']:.1f} s, phase "
        f"{wall:.1f} s | baseline host syncs {syncs} launches {counts} by "
        f"(kernel, n, lanes) {sorted(base_shape.items())} | replicas' "
        f"own launches by replica {per_replica}, summed by (kernel, n, "
        f"lanes) {sorted(by_shape.items())}")
    # The gate: no request lost, every answer and journaled answer bitwise
    # the baseline's, a clean duplicate audit, both killed replicas and the
    # router back, no replica flush that built or loaded the library; the
    # baseline server's launches are this process's, and the fleet's work
    # ran in the replicas: each launched kernels, and together lu_factor
    # and lu_solve at n = 16.
    assert not problems, f"phase 18: check_chaos_record: {problems}"
    assert {tuple(r[:3]): r[3] for r in rec["launches"]["baseline"]} \
        == base_shape, (rec["launches"]["baseline"], base_shape)
    assert all(per_replica.values()), ("phase 18: a replica served with "
                                       "no kernel launch", per_replica)
    n16 = {name for name, n, _ in by_shape if n == 16}
    assert {"lu_factor", "lu_solve"} <= n16, by_shape
    return by_shape


def start_transient_cpu_reruns():
    """Start the CPU re-runs of phase 12's paths and of phase 7's two,
    one worker process each (spawned, so they hold no CUDA context), to
    run while the card works; phase 13's re-runs follow on the first
    workers to finish. Returns the pool, one pending result per phase-12
    path and phase 7's two."""
    pool = multiprocessing.get_context("spawn").Pool(len(TRANSIENT_PATHS)
                                                     + 2)
    last = len(TRANSIENT_PATHS) - 1
    pending = [pool.apply_async(transient_cpu_rerun,
                                (shape, L, abi, method, None, i == last))
               for i, (_, shape, L, abi, method)
               in enumerate(TRANSIENT_PATHS)]
    large = [pool.apply_async(large_cpu_rerun, (use_abi,))
             for use_abi in (False, True)]
    return pool, pending, large


def transient_step_profile(spec, conds, abi, opts, device, label) -> str:
    """Phase 12: the first :data:`STEP_PROFILE_STEPS` steps of a transient
    path's first save interval, [0, 1e-7] s, on its own lanes under
    torch.profiler (after one unprofiled run of them, whose launches,
    host syncs and states the profiled run must repeat exactly): per
    batch step the wall, the device's busy time and the number of device
    kernels.
    (Few steps: the profiler's own processing grows with its events.)
    Returns the log text."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from pycatkin_tpu_torch import engine
    from pycatkin_tpu_torch.frontend import abi as _abi
    from pycatkin_tpu_torch.solvers import ode
    if abi:
        spec = _abi.lower_spec(spec)
        conds = spec.pad_conditions(conds)
    ds = engine.bind(spec, device)
    ct = engine.conditions_to(conds, device)
    lanes = engine._transient_closures(ds, ct, steady_rel=opts.steady_rel)
    L = len(ct.T)
    t0 = torch.zeros(L, dtype=torch.float64, device=device)
    h0 = torch.full((L,), opts.h0, dtype=torch.float64, device=device)
    capped = opts._replace(max_steps=STEP_PROFILE_STEPS)
    run = lambda: ode._advance_to(lanes, ct.y0.contiguous(), t0, 1e-7, h0,
                                  capped)
    first, counts, syncs, _ = counted(run)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        again, wcounts, wsyncs, wall = counted(run)
    steps = ode.SYNCS["ode_active"] - 1
    # The two runs take the same steps, launches and syncs, bit for bit.
    assert wcounts == counts and wsyncs == syncs, (label, wcounts, counts,
                                                   wsyncs, syncs)
    assert all(torch.equal(a, b) for a, b in zip(first, again)), label
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    return (f"{label}: the first {steps} steps of [0, 1e-7] s at {L} "
            f"lanes under the "
            f"profiler: {wall / steps * 1e3:.2f} ms a step, device busy "
            f"{busy / steps:.2f} ms a step ({100.0 * busy / wall / 1e3:.1f} "
            f"% of wall), {len(kernels) / steps:.0f} device kernels a step")


def transient_path(path, shape, L, abi, method, device, pool,
                   pending) -> tuple:
    """Phase 12: ``batch_transient`` of synthetic ``shape`` seed 0 over
    ``L`` lanes at T 400-800 K and :func:`transient_grid`, with walls,
    rates, peak memory, host syncs, steps, the finish and the launches;
    re-run warm, with the same launches and host syncs, where the first
    run took at most :data:`WARM_RERUN_MAX_S`, and its step profile's two
    runs held to each other (:func:`transient_step_profile`); then the
    CPU re-run of its
    :data:`TRANSIENT_SUBSET` lanes (``pending``): ``ok`` and the
    diagnostics equal, ``ys`` within rtol 1e-5 / atol 1e-12; the lanes
    outside it re-run on the CPU (in ``pool``) with T up, T down and
    kscale up by one ulp, and must lie within twice the largest spread
    of those runs, by :data:`TRANSIENT_GATE_BY` seconds after the start.
    Returns the launch counts of the first run, the stage matrices' size
    n, the CPU comparison as a function to call (the last path's is
    called after phase 13, whose card work overlaps its re-run's tail)
    and ``(spec, conds, grid, opts, ys, ok)`` of the first run."""
    import numpy as np
    import torch
    from pycatkin_tpu_torch.frontend import abi as _abi
    from pycatkin_tpu_torch.models.synthetic import synthetic_spec
    from pycatkin_tpu_torch.parallel import batch
    from pycatkin_tpu_torch.solvers import ode
    spec, base = synthetic_spec(*shape, seed=0)
    conds = lanes_over_T(base, L)
    grid = transient_grid()
    opts = ode.ODEOptions(method=method)
    n = _abi.lower_spec(spec).static.n_species if abi else spec.n_species
    run = lambda diag: batch.batch_transient(
        spec, conds, grid, opts=opts, abi=abi, device=device,
        diagnostics=diag)
    diag = {}
    torch.cuda.reset_peak_memory_stats()
    (ys, ok), counts, syncs, wall = counted(lambda: run(diag))
    peak = torch.cuda.max_memory_allocated() / 2**20
    steps = ode.step_counts()
    finish = (ode.FINISH["lanes"], int(ode.FINISH["rescued"]))
    walls = f"wall {wall:.3f} s (one run: the first)"
    if wall <= WARM_RERUN_MAX_S:
        first = wall
        _, wcounts, wsyncs, wall = counted(lambda: run({}))
        assert wcounts == counts and wsyncs == syncs, (wcounts, wsyncs)
        walls = f"wall first {first:.3f} s warm {wall:.3f} s"
    profiles = [transient_step_profile(spec, conds, abi, opts, device,
                                       f"phase 12 {path} step profile")]
    if not abi:
        small = lanes_over_T(synthetic_spec(*shape, seed=0)[1],
                             NARROW_LANES)
        profiles.append(transient_step_profile(
            spec, small, abi, opts, device,
            f"phase 12 {path} step profile, narrow"))
    log(f"phase 12 {path}: synthetic{shape} seed 0 {method}, "
        f"{'abi=True' if abi else 'unpadded'} (stage matrices n = {n}), "
        f"{L} lanes T 400-800 K, {len(grid)} save times 0, 1e-10 .. 1e8 s "
        f"| ok {int(ok.sum())} | finish: {finish[0]} lanes in, "
        f"{finish[1]} rescued | quarantined {diag['quarantined']} | steps "
        f"(lane-steps) "
        f"accepted {steps['accepted']} rejected {steps['rejected']} steady "
        f"{steps['steady']} | host syncs {syncs} | {walls}, "
        f"{L / wall:.1f} lanes/s, "
        f"{L * len(grid) / wall:.1f} save points/s, peak memory "
        f"{peak:.1f} MiB | launches {counts}")
    for text in profiles:
        log(text)
    assert counts["lu_factor"] > 0 and counts["lu_solve"] > 0, counts
    assert ys.shape == (L, len(grid), spec.n_species), ys.shape
    assert diag["quarantined"] == 0 and bool(torch.isfinite(ys).all())
    assert diag["failed"] == int((~ok).sum())

    def parity() -> None:
        idx, sub = cpu_subset(conds, TRANSIENT_SUBSET)
        ys_c, ok_c, diag_c, cwall, csyncs, cstart = pending.get()
        ys_c, ok_c = torch.as_tensor(ys_c), torch.as_tensor(ok_c)
        ys_i, ok_i = ys[idx].cpu(), ok[idx].cpu()
        assert torch.equal(ok_i, ok_c), \
            f"phase 12 {path} CPU parity: ok differs"
        finite = torch.all(torch.isfinite(ys_i[:, -1]), dim=-1)
        assert diag_c == {"failed": int((~(ok_i & finite)).sum()),
                          "quarantined": int((~finite).sum())}, \
            f"phase 12 {path} CPU parity: diagnostics {diag_c}"
        dx, frac = envelope_gap(ys_i, ys_c)
        head = (f"phase 12 {path} CPU parity: {TRANSIENT_SUBSET} lanes "
                f"re-run on the CPU through the plain versions ({cwall:.1f} "
                f"s from t {cstart - START:.1f} s, {csyncs} steps, in a "
                f"worker process while the card ran): ok and diagnostics "
                f"equal, max |dy| {dx:.3e} "
                f"({frac:.3g} of the rtol 1e-5 / atol 1e-12 envelope)")
        share = torch.abs(ys_i - ys_c) / (
            ENVELOPE["atol"] + ENVELOPE["rtol"] * torch.abs(ys_c))
        miss = np.flatnonzero(
            (~(share <= 1.0)).flatten(1).any(dim=1).numpy())
        if miss.size == 0:
            log(head)
            return
        # The lanes outside the envelope, with T up, T down and kscale up
        # by one ulp, as one batch in a worker process.
        left = TRANSIENT_GATE_BY - (time.perf_counter() - START)
        job = pool.apply_async(transient_cpu_rerun,
                               (shape, L, abi, method, miss))
        try:
            runs = job.get(timeout=max(left, 1.0))
        except multiprocessing.TimeoutError:
            raise AssertionError(
                f"{head}: {miss.size} lanes outside it, and their one-ulp "
                f"re-runs on the CPU did not finish by t = "
                f"{TRANSIENT_GATE_BY:.0f} s") from None
        part = type(sub)(*(np.asarray(f)[miss] for f in sub))
        gate = one_ulp_gate(f"phase 12 {path}", spec, part, None,
                            (ys_c[miss],), (ys, ok), idx[miss],
                            {"ys": lambda o: o[0]}, steady=False,
                            runs=[(torch.as_tensor(r),) for r in runs])
        log(f"{head}; its {miss.size} lanes outside it with T up, T down, "
            f"kscale up one ulp: {gate}")
    return counts, n, parity, (spec, conds, grid, opts, ys, ok)


def drc_run(spec, conds, x0, mode, device):
    """``engine.drc`` (``mode="implicit"``) or ``engine.drc_fd``
    (``"fd"``) of the TOF of the last reaction, over ``conds`` from the
    dynamic states ``x0``; returns ``(xi, ok)`` (``ok`` all True for the
    implicit route)."""
    import torch
    from pycatkin_tpu_torch import engine
    ds = engine.bind(spec, device)
    ct = engine.conditions_to(conds, device)
    x0 = torch.as_tensor(x0, dtype=torch.float64, device=device)
    terms = [spec.rnames[-1]]
    if mode == "fd":
        return engine.drc_fd(ds, ct, terms, x0=x0)
    xi = engine.drc(ds, ct, terms, x0=x0)
    return xi, torch.ones(xi.shape[0], dtype=torch.bool, device=device)


def drc_cpu_rerun(shape, lanes: int, idx, x0, mode: str):
    """Phase 13's CPU re-run, in a worker process: the lanes ``idx`` of
    synthetic ``shape`` over ``lanes`` lanes at T 400-800 K (phase 3's or
    phase 7's conditions) from the card's states ``x0``, through the plain
    kernel versions, as they are and with T up, T down and kscale up by
    one ulp. Returns the four ``(xi, ok)`` as numpy arrays and the wall
    seconds."""
    import numpy as np
    import torch
    torch.set_num_threads(1)
    os.nice(19)
    if HERE not in sys.path:
        sys.path.insert(0, HERE)
    from pycatkin_tpu_torch.models.synthetic import synthetic_spec
    spec, base = synthetic_spec(*shape, seed=0)
    conds = lanes_over_T(base, lanes)
    sub = type(conds)(*(np.asarray(f)[idx] for f in conds))
    t0 = time.perf_counter()
    runs = [tuple(t.numpy() for t in drc_run(spec, c, x0, mode, "cpu"))
            for c in (sub,) + one_ulp_conditions(sub)]
    return runs, time.perf_counter() - t0


def drc_parity(label, xi, ok, runs) -> str:
    """The card's ``xi`` / ``ok`` of some lanes against the CPU's
    ``runs`` of them (:func:`drc_cpu_rerun`): ``ok`` and the NaN lanes
    equal; the finite xi within :data:`DRC_ENVELOPE`, else within twice
    the largest spread of the one-ulp runs around the CPU's. Returns the
    log text."""
    import torch
    xi_c, ok_c = (torch.as_tensor(a) for a in runs[0])
    assert torch.equal(ok.cpu(), ok_c), f"{label} CPU parity: ok differs"
    fin = torch.isfinite(xi_c).all(dim=1)
    assert torch.equal(torch.isfinite(xi).all(dim=1).cpu(), fin), \
        f"{label} CPU parity: the NaN lanes differ"
    head = (f"ok equal ({int(ok_c.sum())} of {ok_c.numel()}), NaN lanes "
            f"equal ({int((~fin).sum())})")
    if not bool(fin.any()):
        return head + ", no finite lane to compare"
    a, b = xi.cpu()[fin], xi_c[fin]
    gap, frac = envelope_gap(a, b, DRC_ENVELOPE)
    head += (f", xi max gap {gap:.3e} ({frac:.3g} of the rtol 1e-6 / atol "
             f"1e-9 envelope)")
    spread = max(float(torch.nan_to_num(
        (torch.as_tensor(r[0])[fin] - b).abs(), nan=0.0).max())
        for r in runs[1:])
    if frac <= 1.0:
        return f"{head}; the CPU's one-ulp spread {spread:.3e}"
    assert gap <= 2.0 * spread, \
        f"{label} CPU parity: xi differs by {gap}, {frac:.3g} of the " \
        f"envelope, twice the one-ulp spread is {2.0 * spread}"
    return f"{head}; within twice the CPU's one-ulp spread {spread:.3e}"


def sum_rule(label, spec, conds, x0, xi, device) -> None:
    """The sum rule of the infinite-dilution reactor: scaling every k by
    the same factor scales the TOF by it, so ``sum_r xi_r = 1`` at the
    exact steady state. At the computed one the adjoint gives ``sum_r
    xi_r = 1 - w . F(x*)`` exactly, ``w`` the adjoint vector and ``F(x*)``
    the residual the polished solve leaves; where the Jacobian is badly
    conditioned ``|w|`` reaches ~1e16 and that term is not small. So every
    lane with finite xi must hold the rule with that term within
    :data:`SUM_RULE_TOL`, and every lane whose term is below 1e-7 the plain
    rule; the log gives the lanes that hold the plain rule. ``w`` and
    ``F(x*)`` are recomputed here from the same steady solve."""
    import torch
    from pycatkin_tpu_torch import engine
    from pycatkin_tpu_torch.ops import linalg
    ds = engine.bind(spec, device)
    ct = engine.conditions_to(conds, device)
    x0 = torch.as_tensor(x0, dtype=torch.float64, device=device)
    mask = torch.as_tensor(engine.tof_mask_for(spec, [spec.rnames[-1]]),
                           dtype=torch.float64, device=device)
    with torch.no_grad():
        xs = engine.make_steady_x(ds, x0=x0)(ct)
    F = engine._residual(ds, ct, xs)
    B, M = engine._constrained(ds, engine.steady_jacobian(ds, ct, xs))
    xg = xs.clone().requires_grad_(True)
    with torch.enable_grad():
        y = engine.compose_state(ds, ct.y0, xg)
        (g,) = torch.autograd.grad(
            torch.log(engine.tof(ds, ct, y, mask)).sum(), xg)
    w = linalg.solve(B.mT.contiguous(), g) * (1.0 - M)
    term = -(w * F).sum(dim=1)
    fin = torch.isfinite(xi).all(dim=1) & torch.isfinite(term)
    plain = torch.abs(xi.sum(dim=1) - 1.0)[fin]
    exact = torch.abs(xi.sum(dim=1) - 1.0 - term)[fin]
    small = torch.abs(term[fin]) <= 1e-7
    log(f"{label} sum rule: {int(fin.sum())} lanes with finite xi; "
        f"|sum_r xi_r - 1| <= {SUM_RULE_TOL:g} on "
        f"{int((plain <= SUM_RULE_TOL).sum())}, max {float(plain.max()):.3e}; "
        f"|w . F(x*)| <= 1e-7 on {int(small.sum())}, where the plain rule's "
        f"max is {float(plain[small].max()) if small.any() else 0.0:.3e}; "
        f"max |sum_r xi_r - 1 + w . F(x*)| {float(exact.max()):.3e}, max "
        f"|w| {float(w.abs().max()):.3e}")
    assert float(exact.max()) <= SUM_RULE_TOL, float(exact.max())
    assert not small.any() or float(plain[small].max()) <= SUM_RULE_TOL


def drc_path(label, spec, conds, x0, mode, device) -> tuple:
    """Phase 13: one DRC path on the card, first and, where the first
    took at most :data:`WARM_RERUN_MAX_S`, warm with the same launches;
    logs walls, lanes/s, peak memory, host syncs, NaN lanes, the ``ok``
    count and launches. Returns ``(xi, ok, launch counts)``."""
    import torch
    L = len(conds.T)
    torch.cuda.reset_peak_memory_stats()
    (xi, ok), counts, syncs, wall = counted(
        lambda: drc_run(spec, conds, x0, mode, device))
    peak = torch.cuda.max_memory_allocated() / 2**20
    walls = f"wall first {wall:.3f} s"
    if wall <= WARM_RERUN_MAX_S:
        _, wcounts, _, wall = counted(
            lambda: drc_run(spec, conds, x0, mode, device))
        assert wcounts == counts, (wcounts, counts)
        walls += f" warm {wall:.3f} s"
    nan = int((~torch.isfinite(xi).all(dim=1)).sum())
    solves = L * (2 * spec.n_reactions + 1) if mode == "fd" else L
    log(f"{label}: {L} lanes ({solves} steady solves), n_dyn "
        f"{len(spec.dynamic_indices)} | ok {int(ok.sum())} | NaN lanes "
        f"{nan} | host syncs {syncs} | {walls}, {L / wall:.1f} lanes/s | "
        f"peak memory {peak:.1f} MiB | launches {counts}")
    assert xi.shape == (L, spec.n_reactions), xi.shape
    return xi, ok, counts


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import pycatkin_tpu_torch  # noqa: F401  (fails outside the repo)
    pool, pending, large = start_transient_cpu_reruns()
    try:
        return run_phases(pool, pending, large)
    finally:
        pool.terminate()
        pool.join()


def run_phases(pool, pending, large) -> int:
    import numpy as np
    import torch
    from pycatkin_tpu_torch import engine
    from pycatkin_tpu_torch.frontend import abi
    from pycatkin_tpu_torch.models.synthetic import synthetic_spec
    from pycatkin_tpu_torch.ops import cuda_linalg as cl
    from pycatkin_tpu_torch.ops import linalg
    from pycatkin_tpu_torch.solvers.newton import deflation_basis_for_spec

    device = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    cl.build(verbose=True)
    # The float32 bulk products (net @ stoich.T, the gross flux) must run
    # in full float32: the port never sets TF32 on.
    assert not torch.backends.cuda.matmul.allow_tf32
    log(f"phase 1 device: {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | kernels built in "
        f"{time.perf_counter() - t0:.2f} s | float32 matmul allow_tf32 "
        f"{torch.backends.cuda.matmul.allow_tf32}")

    # -- phase 2: kernels against their plain versions -----------------
    check_kernels(cl, device, torch.float64)
    check_kernels(cl, device, torch.float32)
    check_gauss(device)
    check_prng(device)
    log("phase 2 kernel check: all sizes passed")

    # -- phase 3: the flagship path (Gauss-Jordan, no kernel) ----------
    spec, base = synthetic_spec(24, 32, seed=0)
    L = FLAGSHIP_LANES
    conds = lanes_over_T(base, L)
    mask = engine.tof_mask_for(spec, [spec.rnames[-1]])
    torch.cuda.reset_peak_memory_stats()
    out, counts, syncs, wall = counted(fused(spec, conds, mask, device))
    peak = torch.cuda.max_memory_allocated() / 2**20
    res = out[0]
    v = verdicts(out)
    n_dyn = len(spec.dynamic_indices)
    bundle = out[-1].cpu().tolist()
    log(f"phase 3 flagship path: synthetic(24, 32) n_dyn={n_dyn} "
        f"({linalg.select_solver(n_dyn).path}), {L} lanes T 400-800 K | "
        f"converged {int(v['success'].sum())} quarantined "
        f"{int(v['quarantined'].sum())} certified "
        f"{int(v['certified'].sum())} ambiguous "
        f"{int(v['ambiguous'].sum())} negative-TOF "
        f"{int(v['negative_tof'].sum())} | bundle {bundle} | median "
        f"iterations {float(res.iterations.double().median()):.0f} max "
        f"{int(res.iterations.max())} | host syncs {syncs} | wall "
        f"{wall:.3f} s, {L / wall:.1f} lanes/s, peak memory {peak:.1f} MiB "
        f"| launches {counts}")
    assert set(counts.values()) == {0}, counts
    assert res.x.shape == (L, spec.n_species)
    ok = v["success"]
    assert bool(torch.isfinite(res.x[ok]).all())
    assert bool(torch.isfinite(out[5][ok & v["certified"]]).all())
    fused_cpu_parity("phase 3", spec, conds, mask, out, hold_states=False)
    # Phase 13c's lanes (every 64th) and its CPU re-run of 16 of them.
    dyn = list(spec.dynamic_indices)
    fd_idx, fd_conds = cpu_subset(conds, DRC_FD_LANES)
    fd_sub, _ = cpu_subset(fd_conds, DRC_SUBSET)
    fd_edge = int(np.flatnonzero(fd_idx == DRC_FD_EDGE_LANE)[0])
    fd_rerun = np.append(fd_sub, fd_edge)
    fd_x0 = out[0].x[torch.as_tensor(fd_idx, device=device)][:, dyn]
    fd_job = pool.apply_async(drc_cpu_rerun, (
        (24, 32), L, fd_idx[fd_rerun], fd_x0[fd_rerun].cpu().numpy(), "fd"))

    # -- phase 4: the certificate path ---------------------------------
    cspec, cbase = synthetic_spec(12, 14, seed=0)
    Lc = CERT_LANES
    cconds = lanes_over_T(cbase, Lc)
    cmask = engine.tof_mask_for(cspec, [cspec.rnames[-1]])
    cout, ccounts, csyncs, cwall = counted(fused(cspec, cconds, cmask,
                                                 device))
    cv = verdicts(cout)
    log(f"phase 4 certificate path: synthetic(12, 14) seed 0, {Lc} lanes | "
        f"converged {int(cv['success'].sum())} certified "
        f"{int(cv['certified'].sum())} ambiguous "
        f"{int(cv['ambiguous'].sum())} | host syncs {csyncs} | wall "
        f"{cwall:.3f} s | launches {ccounts}")
    assert ccounts["factor_solve"] > 0, ccounts
    fused_cpu_parity("phase 4", cspec, cconds, cmask, cout, hold_states=True)

    # -- phase 5: the ABI flagship path --------------------------------
    low = abi.lower_spec(spec)
    assert low.static.n_dynamic == 32 and low.lyap_ok == 0.0
    torch.cuda.reset_peak_memory_stats()
    run_abi = abi_sweep(spec, conds, mask, device)
    aout, acounts, asyncs, awall = counted(run_abi)
    apeak = torch.cuda.max_memory_allocated() / 2**20
    report_abi("phase 5 ABI flagship path", low, L, aout, acounts, asyncs,
               awall, apeak)
    assert all(acounts[k] > 0 for k in cl.LAUNCHES), acounts
    abi_cpu_parity("phase 5", spec, conds, mask, aout)

    # -- phase 6: the ABI certificate path -----------------------------
    sspec, sbase = synthetic_spec(10, 5, seed=0)
    slow = abi.lower_spec(sspec)
    assert slow.static.n_dynamic == 8 and slow.lyap_ok == 1.0
    Ls = ABI_CERT_LANES
    sconds = lanes_over_T(sbase, Ls)
    smask = engine.tof_mask_for(sspec, [sspec.rnames[-1]])
    torch.cuda.reset_peak_memory_stats()
    sout, scounts, ssyncs, swall = counted(abi_sweep(sspec, sconds, smask,
                                                     device))
    speak = torch.cuda.max_memory_allocated() / 2**20
    report_abi("phase 6 ABI certificate path", slow, Ls, sout, scounts,
               ssyncs, swall, speak)
    assert scounts["factor_solve"] > 0, scounts
    abi_cpu_parity("phase 6", sspec, sconds, smask, sout)

    # -- phase 7: the large path, both ways -----------------------------
    gspec, gbase = synthetic_spec(200, 200, seed=0)
    Lg = LARGE_LANES
    gconds = lanes_over_T(gbase, Lg)
    gmask = engine.tof_mask_for(gspec, [gspec.rnames[-1]])
    g_dyn = len(gspec.dynamic_indices)
    assert g_dyn == 165 and linalg.select_solver(g_dyn).path == "lu"
    torch.cuda.reset_peak_memory_stats()
    run_large = fused(gspec, gconds, gmask, device)
    gout, gcounts, gsyncs, gwall = counted(run_large)
    gpeak = torch.cuda.max_memory_allocated() / 2**20
    gv = verdicts(gout)
    log(f"phase 7 large path: synthetic(200, 200) seed 0 n_dyn={g_dyn} "
        f"({linalg.select_solver(g_dyn).path}), {Lg} lanes T 400-800 K | "
        f"converged {int(gv['success'].sum())} quarantined "
        f"{int(gv['quarantined'].sum())} | median iterations "
        f"{float(gout[0].iterations.double().median()):.0f} max "
        f"{int(gout[0].iterations.max())} | host syncs {gsyncs} | wall "
        f"{gwall:.3f} s, {Lg / gwall:.1f} lanes/s, peak memory "
        f"{gpeak:.1f} MiB | launches {gcounts}")
    assert gcounts["lu_factor"] > 0 and gcounts["lu_solve"] > 0, gcounts
    assert bool(torch.isfinite(gout[0].x[gv["success"]]).all())
    gdyn = list(gspec.dynamic_indices)
    g_sub, _ = cpu_subset(gconds, DRC_SUBSET)
    g_job = pool.apply_async(drc_cpu_rerun, (
        (200, 200), Lg, g_sub,
        gout[0].x[torch.as_tensor(g_sub, device=device)][:, gdyn].cpu()
        .numpy(), "implicit"))
    # Phase 14's CPU prefixes, behind phase 13's re-runs in the pool.
    tier_jobs = {p[0]: pool.apply_async(tier_cpu_rerun, (p[0],))
                 for p in TIER_PATHS}
    glow = abi.lower_spec(gspec)
    assert glow.static.n_dynamic == 256
    assert linalg.select_solver(glow.static.n_dynamic).path == "lu"
    torch.cuda.reset_peak_memory_stats()
    run_large_abi = abi_sweep(gspec, gconds, gmask, device,
                              check_stability=False)
    hout, hcounts, hsyncs, hwall = counted(run_large_abi)
    hpeak = torch.cuda.max_memory_allocated() / 2**20
    report_abi("phase 7 large ABI path", glow, Lg, hout, hcounts, hsyncs,
               hwall, hpeak, note=" (check_stability=False: the tier-2 "
               "host eigensolve at n = 256 is host time, not measured here)")
    assert hcounts["lu_factor"] > 0 and hcounts["lu_solve"] > 0, hcounts

    # -- phase 8: where the time goes -----------------------------------
    w_abi = profile_path(run_abi, L, "ABI flagship")
    profile_path(run_large, Lg, "large")
    w_large_abi = profile_path(run_large_abi, Lg, "large ABI")
    _, _, _, fwall = counted(fused(spec, conds, mask, device))
    log(f"phase 8 warm flagship: wall {fwall:.3f} s, {L / fwall:.1f} "
        f"lanes/s")
    A21, b21 = test_matrices(L - 1, n_dyn, seed=3, device=device)
    gj_ms = cuda_ms(lambda: linalg.gauss_solve(A21, b21), 3, warmup=1)
    log(f"phase 8 Gauss-Jordan solve (plain PyTorch gauss_solve, one "
        f"right-hand side) n={n_dyn} x {L} lanes: {gj_ms:.3f} ms")
    del A21, b21

    # -- phase 10: the rescue path -------------------------------------
    rcounts = rescue_path(spec, conds, mask, device)

    # -- phase 11: the flagship entry as written ---------------------
    entry_path(spec, base, mask, device)

    # Phase 7's CPU comparisons: their re-runs had phases 8-11 to finish.
    fused_cpu_parity("phase 7 large", gspec, gconds, gmask, gout,
                     hold_states=False, subset=LARGE_SUBSET,
                     envelope=LARGE_ENVELOPE, cpu=large[0].get())
    abi_cpu_parity("phase 7 large ABI", gspec, gconds, gmask, hout,
                   check_stability=False, hold_states=False,
                   subset=LARGE_SUBSET, envelope=LARGE_ENVELOPE,
                   cpu=large[1].get())

    # -- phase 12: the transient, three paths --------------------------
    # Their CPU comparisons wait: the first two until after phase 13, the
    # last until after phase 9's timings, so the card runs on meanwhile.
    tcounts, parities, truns = {}, [], {}
    for (path, shape, Lt, use_abi, method), res in zip(TRANSIENT_PATHS,
                                                        pending):
        tc, nt, parity, truns[path] = transient_path(
            path, shape, Lt, use_abi, method, device, pool, res)
        tcounts[path] = (tc, nt, Lt)
        parities.append(parity)

    # -- phase 13: degree of rate control --------------------------------
    left = lambda: max(TRANSIENT_GATE_BY - (time.perf_counter() - START), 1.0)
    x3 = out[0].x[:, dyn]
    xa, oka, ca = drc_path("phase 13a implicit DRC, flagship", spec, conds,
                           x3, "implicit", device)
    assert set(ca.values()) == {0}, ca
    assert bool(oka.all())
    sum_rule("phase 13a", spec, conds, x3, xa, device)
    idx, sub = cpu_subset(conds)
    x0c = x3[torch.as_tensor(idx, device=device)].cpu()
    t0 = time.perf_counter()
    runs = [drc_run(spec, c, x0c, "implicit", "cpu")
            for c in (sub,) + one_ulp_conditions(sub)]
    log(f"phase 13a CPU parity: {SUBSET} lanes re-run on the CPU, and with "
        f"T up, T down, kscale up one ulp ({time.perf_counter() - t0:.1f} "
        f"s): {drc_parity('phase 13a', xa[idx], oka[idx], runs)}")

    xb, okb, cb = drc_path("phase 13b implicit DRC, large", gspec, gconds,
                           gout[0].x[:, gdyn], "implicit", device)
    assert cb["factor_solve"] == 3, cb
    assert bool(okb.all())
    sum_rule("phase 13b", gspec, gconds, gout[0].x[:, gdyn], xb, device)
    runs, cwall = g_job.get(timeout=left())
    gi = torch.as_tensor(g_sub, device=device)
    log(f"phase 13b CPU parity: {DRC_SUBSET} lanes re-run on the CPU in a "
        f"worker, and with T up, T down, kscale up one ulp ({cwall:.1f} s): "
        f"{drc_parity('phase 13b', xb[gi], okb[gi], runs)}")

    xc, okc, cc = drc_path("phase 13c FD DRC, flagship", spec, fd_conds,
                           fd_x0, "fd", device)
    assert set(cc.values()) == {0}, cc
    nok = np.flatnonzero(~okc.cpu().numpy())
    log(f"phase 13c lanes not ok (index of {DRC_FD_LANES}, flagship lane, "
        f"T): {[(int(i), int(fd_idx[i]), float(fd_conds.T[i])) for i in nok]}"
        f" | their states x0 {fd_x0[torch.as_tensor(nok)].tolist()}")
    runs, cwall = fd_job.get(timeout=left())
    fi = torch.as_tensor(fd_sub, device=device)
    edge_ok = [bool(o[-1]) for _, o in runs]
    gated = [(x[:-1], o[:-1]) for x, o in runs]
    log(f"phase 13c CPU parity: {DRC_SUBSET} lanes re-run on the CPU in a "
        f"worker, and with T up, T down, kscale up one ulp ({cwall:.1f} s): "
        f"{drc_parity('phase 13c', xc[fi], okc[fi], gated)}"
        f" | edge lane {DRC_FD_EDGE_LANE} (not gated): ok on the card "
        f"{bool(okc[fd_edge])}, on the CPU as is / T up / T down / kscale "
        f"up {edge_ok}")

    for parity in parities[:-1]:
        parity()

    # -- phase 14: the f32-polish tier on three paths ---------------------
    from pycatkin_tpu_torch.parallel import batch
    run64 = lambda: batch.sweep_steady_state(spec, conds, mask,
                                             check_stability=True,
                                             device=device)
    torch.cuda.reset_peak_memory_stats()
    fout, _, fsyncs, f1 = counted(run64)
    fpeak = torch.cuda.max_memory_allocated() / 2**20
    _, _, _, fw = counted(run64)
    refs = {"flagship": (spec, fout, (f1, fw, fsyncs, fpeak)),
            "abi_flagship": (spec, aout, (awall, w_abi, asyncs, apeak)),
            "large_abi": (gspec, hout, (hwall, w_large_abi, hsyncs, hpeak))}
    tier_counts = {}
    for label, shape, Lt, use_abi, check, _, env in TIER_PATHS:
        tspec, ref, stats = refs[label]
        tconds = conds if tspec is spec else gconds
        tmask = mask if tspec is spec else gmask
        tier_counts[label] = tier_path(label, tspec, tconds, tmask, use_abi,
                                       check, env, ref, stats,
                                       tier_jobs[label], device)
    del fout

    # -- phase 15: the packed multi-tenant sweep ---------------------------
    pack_counts = pack_phase(device)

    # -- phase 16: the sweep server on the card ----------------------------
    serve_counts = serve_phase(device)

    # -- phase 17: the robustness layer on the card -----------------------
    serve_counts["chunked_abi"], chunked_tcounts = robust_phase(
        spec, conds, mask, aout, truns.pop("transient_esdirk4"),
        tcounts["transient_esdirk4"][0], device)
    truns.clear()

    # -- phase 18: the fleet on the card ----------------------------------
    serve_counts["serve_fleet"] = fleet_phase()

    # -- phase 9, kernels line: one row per kernel per path ---------------
    # Each distinct (kernel, n, lanes, type) is checked against its plain
    # version and timed once; every path row at that shape shares it.
    memo = {}

    def lu_rows(n, lanes, dtype=None):
        key = ("lu", n, lanes, dtype)
        if key not in memo:
            memo[key] = time_lu(cl, n, lanes, device, dtype)
        return memo[key]

    def fs_row(n, lanes, dtype=None):
        key = ("factor_solve", n, lanes, dtype)
        if key not in memo:
            memo[key] = time_factor_solve(cl, n, lanes, device, dtype)
        return memo[key]

    m = deflation_basis_for_spec(cspec).shape[1]
    assert m * m > linalg.UNROLL_MAX, m
    fs16 = fs_row(abi.LYAP_PAD ** 2, L)
    timed = [("certificate", ccounts, fs_row(m * m, Lc))]
    timed += [("abi_flagship", acounts, r)
              for r in lu_rows(low.static.n_dynamic, L) + [fs16]]
    timed += [("abi_certificate", scounts, fs16)]
    # The rescue path's largest shapes: the fast pass and, where every
    # lane fails it, the polish rung run n = 32 on all L lanes.
    timed += [("rescue_abi", rcounts, r) for _, c, r in timed
              if c is acounts]
    large_lu = lu_rows(g_dyn, Lg)
    timed += [("large", gcounts, r) for r in large_lu]
    timed += [("large_abi", hcounts, r)
              for r in lu_rows(glow.static.n_dynamic, Lg)]
    # The transient's stage matrices: n_s unpadded, S through abi=True;
    # phase 17c's chunked route at phase 12's ESDIRK4 shape.
    for path, (tc, nt, Lt) in tcounts.items():
        rows = lu_rows(nt, Lt)
        timed += [(path, tc, r) for r in rows]
        if path == "transient_esdirk4":
            timed += [("transient_chunked", chunked_tcounts, r)
                      for r in rows]
    # Phase 13b: the polish and adjoint solves at n = 165, and the steady
    # solve's LU where it stepped.
    timed += [("drc_large", cb, r)
              for r in large_lu + [fs_row(g_dyn, Lg)]
              if cb[r["name"]] > 0]
    # Phases 14 and 15: the float32 builds at the tier's path shapes (the
    # float64 polish and certificate launch the float64 ones there too),
    # and the packed sweep (four tenants of 16,384 lanes: the direction
    # solves at n = 32 x 65,536, the certificate per tenant at 16).
    assert not torch.backends.cuda.matmul.allow_tf32
    on_path = lambda path, c, rows: [(path, c, r) for r in rows
                                     if c[r["name"]] > 0]
    rows_of = lambda path: [r for p_, _, r in timed if p_ == path]
    abi_rows = rows_of("abi_flagship")
    f32_abi = lu_rows(low.static.n_dynamic, L, torch.float32)
    f32_large = lu_rows(glow.static.n_dynamic, Lg, torch.float32)
    timed += on_path("abi_flagship_f32", tier_counts["abi_flagship"],
                     f32_abi + abi_rows)
    timed += on_path("large_abi_f32", tier_counts["large_abi"],
                     f32_large + rows_of("large_abi"))
    pack_rows = abi_rows[:2] + [fs_row(abi.LYAP_PAD ** 2, PACK_LANES)]
    timed += on_path("packed", pack_counts["f64"], pack_rows)
    timed += on_path("packed_f32", pack_counts["f32-polish"],
                     f32_abi + pack_rows)
    # Phases 16, 17a and 18: each serve path's and the chunked sweep's
    # kernels at every (n, lanes) they launched at, each shape checked and
    # timed as it launched (the full-width sweep's n = 32 x 65,536 is
    # phase 5's).
    for path in ("serve", "serve_transient", "serve_full", "chunked_abi",
                 "serve_fleet"):
        for (name, n, lanes), c in sorted(serve_counts[path].items()):
            rows = ([fs_row(n, lanes)] if name == "factor_solve"
                    else lu_rows(n, lanes))
            timed += [(path, {name: c}, r) for r in rows
                      if r["name"] == name]
    replaces = {
        "lu_factor": "pycatkin_tpu/ops/pallas_linalg.py:204",
        "lu_solve": "pycatkin_tpu/ops/pallas_linalg.py:219",
        "factor_solve": "pycatkin_tpu/ops/pallas_linalg.py:233",
    }
    replaces.update({k + "_f32": v for k, v in replaces.items()})
    kernels = []
    for path, path_counts, r in timed:
        assert path_counts[r["name"]] > 0, (path, r["name"])
        kernels.append(dict(
            name=r["name"], route="cuda",
            source="pycatkin_tpu_torch/csrc/linalg.cu",
            replaces=replaces[r["name"]], launches=path_counts[r["name"]],
            max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            bound_share=r["bound_ms"] / r["ms"], path=path, n=r["n"],
            lanes=r["lanes"]))
        log(f"timing {r['name']} ({path}, {path_counts[r['name']]} "
            f"launches): n={r['n']} x {r['lanes']} lanes | kernel "
            f"{r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms torch.linalg "
            f"{r['library_ms']:.4f} ms bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}, {r['bound_ms'] / r['ms']:.3f} of it) "
            f"{'FP32' if r['name'].endswith('_f32') else 'FP64'} "
            f"vector floor {r['vector_floor_ms']:.4f} ms | host "
            f"{r['host_us']:.1f} us a launch")
    # Shapes on no path: the bucket-512 kernels, factor_solve at 256, 512;
    # the float32 builds of those and factor_solve_f32 at the float64
    # paths' shapes (no path runs it: the certificate and DRC stay
    # float64).
    f32 = torch.float32
    off_path = lu_rows(512, 256) + [
        fs_row(n, L_) for n, L_ in ((256, Lg), (512, 256))]
    off_path += lu_rows(512, 256, f32) + [
        fs_row(n, L_, f32) for n, L_ in ((abi.LYAP_PAD ** 2, L), (m * m, Lc), (g_dyn, Lg),
                      (256, Lg), (512, 256))]
    for r in off_path:
        log(f"timing {r['name']} (no path): n={r['n']} x {r['lanes']} "
            f"lanes | kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms "
            f"torch.linalg {r['library_ms']:.4f} ms bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}) "
            f"{'FP32' if r['name'].endswith('_f32') else 'FP64'} vector "
            f"floor {r['vector_floor_ms']:.4f} ms | host "
            f"{r['host_us']:.1f} us a launch | max abs err "
            f"{r['max_abs_err']:.3e}")
    # Phase 12's last CPU comparison: its re-run had phases 13-15 and the
    # timings to finish.
    parities[-1]()
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
