"""The port's degradation ladder (``robustness/ladder.py``), the sweep
tail's hooks (``parallel/batch.py``) and the presets' ladder
(``api/presets.py``) against the JAX package's.

- The ladder rung by rung, the counterparts of ``tests/test_faults.py``'s
  ladder cases (on the CPU, as those run); "requeue" re-targets a device
  other than the run's, here two CPU devices standing in for two cards.
  A run on the card takes no host fallback unless its policy opts in,
  and a card fault (a kernel that fails to build, load or launch)
  propagates from the ladder.
- The tail's ``rescue`` and ``degradation`` events and its counter and
  histogram deltas equal the JAX package's on the same sweep: clean,
  with rescued lanes (a capped first pass), and with a NaN-poisoned lane
  that the rescue ladder recovers or, its rescues poisoned too, leaves
  quarantined.
- A preset sweep whose steady solve fails on every rung degrades to the
  transient finals with the JAX package's ``transient-fallback`` event.
"""

import numpy as np
import pytest
import torch

import pycatkin_tpu.obs.metrics as jmetrics
from pycatkin_tpu import engine as jengine
from pycatkin_tpu.models.synthetic import synthetic_system as jsynthetic
from pycatkin_tpu.parallel import batch as jbatch
from pycatkin_tpu.robustness import FaultPlan as JFaultPlan
from pycatkin_tpu.robustness import fault_scope as jfault_scope
from pycatkin_tpu.utils import profiling as jprofiling
from pycatkin_tpu_torch import engine
from pycatkin_tpu_torch.models.synthetic import synthetic_system
from pycatkin_tpu_torch.obs import metrics
from pycatkin_tpu_torch.parallel import batch
from pycatkin_tpu_torch.robustness import (ChunkAbandonedError,
                                           DegradationPolicy, FaultPlan,
                                           fault_scope, ladder,
                                           run_chunk_with_ladder)
from pycatkin_tpu_torch.utils import profiling

_FAST = DegradationPolicy(base_delay_s=0.001, max_delay_s=0.002)
N_LANES = 32
BAD_LANE = 5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tensors: one intra-op thread is as fast and spares the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------
# The ladder rung by rung.

def test_ladder_clean_call_passes_through():
    profiling.drain_events()
    out, events = run_chunk_with_ladder(lambda device=None: 7,
                                        label="c", policy=_FAST)
    assert out == 7 and events == []
    assert not profiling.peek_events("degradation")


@pytest.mark.parametrize("home", [0, 1])
def test_ladder_requeue_recovers_on_other_device(monkeypatch, home):
    """A permanent fault on the first dispatch only: the retry rung fails
    fast (device loss is not transient) and the requeue rung's
    re-dispatch on the other device than the run's succeeds."""
    devs = [torch.device("cpu", 0), torch.device("cpu", 1)]
    monkeypatch.setattr(ladder, "_local_devices", lambda: devs)
    seen = []

    def run(device=None):
        seen.append(device)
        return "ok"

    plan = FaultPlan([{"site": "c", "kind": "permanent", "times": 1}])
    with fault_scope(plan):
        out, events = run_chunk_with_ladder(run, label="c", policy=_FAST,
                                            device=devs[home])
    assert out == "ok"
    assert [e["rung"] for e in events] == ["retry", "requeue", "requeue"]
    assert seen == [devs[1 - home]]              # re-targeted device


def test_ladder_skips_requeue_on_one_card_and_falls_back_to_host():
    """Without a second card the requeue rung is skipped; the host
    fallback re-dispatches on the CPU, with its events and counter."""
    before = metrics.counter("pycatkin_ladder_rung_total").values()
    seen = []

    def run(device=None):
        seen.append(device)
        return "ok"

    plan = FaultPlan([{"site": "c", "kind": "permanent", "times": 1}])
    with fault_scope(plan):
        out, events = run_chunk_with_ladder(run, label="c", policy=_FAST,
                                            device="cpu")
    assert out == "ok" and seen == [torch.device("cpu")]
    assert [e["rung"] for e in events] == ["retry", "host-fallback",
                                           "host-fallback"]
    after = metrics.counter("pycatkin_ladder_rung_total").values()
    key = 'rung="host-fallback"'
    assert after[key] - before.get(key, 0.0) == 2.0


def test_ladder_nan_validation_escalates_and_recovers():
    plan = FaultPlan([{"site": "c", "kind": "nan", "times": 1}])

    def run(device=None):
        return {"y": np.ones((2, 2))}

    def validate(out):
        return ("poisoned" if not np.isfinite(out["y"]).all() else None)

    with fault_scope(plan):
        out, events = run_chunk_with_ladder(run, label="c", policy=_FAST,
                                            validate=validate, device="cpu")
    assert np.isfinite(out["y"]).all()
    assert any("rejected" in e["detail"] for e in events)


def test_ladder_salvage_returns_none_and_reports():
    profiling.drain_events()
    plan = FaultPlan([{"site": "c", "kind": "permanent", "times": None}])
    with fault_scope(plan):
        out, events = run_chunk_with_ladder(
            lambda device=None: 1, label="c", policy=_FAST)
    assert out is None
    assert events[-1]["rung"] == "salvage"
    evs = profiling.drain_events()
    assert any(e["kind"] == "degradation" and e["rung"] == "salvage"
               for e in evs)


def test_ladder_card_run_takes_host_fallback_only_when_opted_in():
    """A run on the card whose chunk fails is salvaged, never re-run on
    the host, unless its policy sets ``host_fallback=True``."""
    for policy, rungs, got in (
            (_FAST, ["retry", "salvage"], None),
            (DegradationPolicy(base_delay_s=0.001, max_delay_s=0.002,
                               host_fallback=True),
             ["retry", "host-fallback", "host-fallback"], "ok")):
        seen = []

        def run(device=None):
            seen.append(device)
            return "ok"

        plan = FaultPlan([{"site": "c", "kind": "permanent", "times": 1}])
        with fault_scope(plan):
            out, events = run_chunk_with_ladder(run, label="c",
                                                policy=policy,
                                                device="cuda:0")
        assert out == got and [e["rung"] for e in events] == rungs
        assert seen == ([] if got is None else [torch.device("cpu")])


@pytest.mark.parametrize("home", ["cpu", "cuda:0"])
def test_ladder_card_fault_propagates(home):
    """A kernel that fails to launch is a fault of the card: it leaves
    the ladder at once, with no rung fired, even where the policy would
    fall back to the host."""
    from pycatkin_tpu_torch.ops.cuda_linalg import KernelError
    calls = []

    def run(device=None):
        calls.append(device)
        raise KernelError("lu_factor: CUDA kernel launch failed with "
                          "cudaError 700")

    profiling.drain_events()
    policy = DegradationPolicy(base_delay_s=0.001, max_delay_s=0.002,
                               host_fallback=True)
    with pytest.raises(KernelError):
        run_chunk_with_ladder(run, label="c", policy=policy, device=home)
    assert calls == [None]
    assert not profiling.peek_events("degradation")


def test_ladder_salvage_disabled_raises():
    plan = FaultPlan([{"site": "c", "kind": "permanent", "times": None}])
    pol = DegradationPolicy(base_delay_s=0.001, max_delay_s=0.002,
                            salvage=False)
    with fault_scope(plan):
        with pytest.raises(ChunkAbandonedError):
            run_chunk_with_ladder(lambda device=None: 1, label="c",
                                  policy=pol)


# ---------------------------------------------------------------------
# The sweep tail's hooks against the JAX package's.

_COUNTERS = ("pycatkin_lanes_solved_total", "pycatkin_rescue_lanes_total",
             "pycatkin_rescued_lanes_total", "pycatkin_ladder_rung_total",
             "pycatkin_quarantined_lanes_total",
             "pycatkin_tier2_escalations_total",
             "pycatkin_retry_attempts_total")
_HISTOGRAMS = ("pycatkin_lane_iterations", "pycatkin_lane_chords",
               "pycatkin_lane_residual_decade")
_EVENT_KEYS = ("kind", "label", "rung", "lanes", "n_failed", "n_remaining",
               "detail")


def _deltas(before, after):
    """Counter deltas and histogram count/bucket deltas, by label."""
    out = {}
    for name in _COUNTERS:
        a = after["counters"].get(name, {})
        b = before["counters"].get(name, {})
        d = {k: v - b.get(k, 0.0) for k, v in a.items()
             if v - b.get(k, 0.0)}
        if d:
            out[name] = d
    for name in _HISTOGRAMS:
        a = after["histograms"].get(name, {})
        b = before["histograms"].get(name, {})
        for k, st in a.items():
            old = b.get(k, {"count": 0, "buckets": [0] * len(st["buckets"])})
            if st["count"] - old["count"]:
                # The residual decades are compared by count only: a
                # rescued lane's residual is the port's within the
                # solver's envelope, not bit for bit, and one sits at a
                # decade boundary (9.87e-4 against 1.02e-3).
                out[f"{name}{{{k}}}"] = (
                    st["count"] - old["count"],
                    None if name == "pycatkin_lane_residual_decade" else
                    [x - y for x, y in zip(st["buckets"], old["buckets"])])
    return out


def _events(evs):
    return [{k: e[k] for k in _EVENT_KEYS if k in e} for e in evs
            if e["kind"] in ("rescue", "degradation", "retry")]


@pytest.fixture(scope="module")
def pair():
    """(JAX spec, port spec, conditions, TOF mask, solver options)."""
    sj = jsynthetic(n_species=16, n_reactions=24, seed=3)
    sp = synthetic_system(n_species=16, n_reactions=24, seed=3,
                          device="cpu")
    conds = jbatch.broadcast_conditions(sj.conditions(), N_LANES)
    conds = conds._replace(T=np.linspace(480.0, 620.0, N_LANES))
    mask = jengine.tof_mask_for(sj.spec, [sj.spec.rnames[-1]])
    return sj.spec, sp.spec, conds, mask, sj.solver_options()


_SCENARIOS = {
    "clean": (None, {}),
    "rescued": (None, dict(max_steps=6)),
    "quarantine-recovered": (
        [{"site": "batched steady solve", "kind": "nan",
          "lanes": [BAD_LANE], "times": 1}], {}),
    "quarantine-unrecovered": (
        [{"site": "batched steady solve", "kind": "nan",
          "lanes": [BAD_LANE], "times": 1},
         {"site": "rescue*", "kind": "nan", "times": None}], {}),
}


@pytest.mark.parametrize("scenario", sorted(_SCENARIOS))
def test_tail_events_and_counters_match_jax(pair, scenario):
    """The same sweep (check_stability, TOF) through both packages: the
    verdicts, the rescue/degradation events and every counter and
    histogram delta agree."""
    spec_j, spec_p, conds, mask, opts = pair
    specs, over = _SCENARIOS[scenario]
    opts = opts._replace(**over)
    runs = []
    for pkg in ("jax", "port"):
        m, prof = (jmetrics, jprofiling) if pkg == "jax" else \
            (metrics, profiling)
        scope = (jfault_scope if pkg == "jax" else fault_scope)(
            None if specs is None else
            (JFaultPlan if pkg == "jax" else FaultPlan)(specs))
        prof.drain_events()
        before = m.snapshot()
        with scope:
            if pkg == "jax":
                out = jbatch.sweep_steady_state(spec_j, conds, tof_mask=mask,
                                                opts=opts,
                                                check_stability=True)
            else:
                out = batch.sweep_steady_state(spec_p, conds, tof_mask=mask,
                                               opts=opts,
                                               check_stability=True,
                                               device="cpu")
        runs.append((_deltas(before, m.snapshot()),
                     _events(prof.drain_events()),
                     {k: np.asarray(out[k]) for k in ("success",
                                                      "quarantined")}))
    (dj, ej, oj), (dp, ep, op) = runs
    for k in oj:
        np.testing.assert_array_equal(op[k], oj[k], err_msg=k)
    assert ep == ej
    assert dp == dj
    if scenario == "rescued":
        assert any(e["kind"] == "rescue" for e in ep)
    if scenario.startswith("quarantine"):
        assert any(e.get("rung") == "quarantine"
                   and BAD_LANE in e["lanes"] for e in ep)
        assert bool(op["quarantined"][BAD_LANE])
        assert bool(op["success"][BAD_LANE]) == scenario.endswith(
            "-recovered")


def test_split_route_under_a_plan_matches_the_fused_route(pair):
    """Under an active fault plan (one that never fires) the sweep takes
    the split route, as the JAX package does; its result is the fused
    route's bit for bit."""
    _, spec_p, conds, mask, opts = pair
    fused = batch.sweep_steady_state(spec_p, conds, tof_mask=mask,
                                     opts=opts, check_stability=True,
                                     device="cpu")
    with fault_scope(FaultPlan([{"site": "never", "kind": "permanent"}])):
        split = batch.sweep_steady_state(spec_p, conds, tof_mask=mask,
                                         opts=opts, check_stability=True,
                                         device="cpu")
    assert sorted(fused) == sorted(split)
    for k in fused:
        assert torch.equal(fused[k], split[k]), k


# ---------------------------------------------------------------------
# The presets' ladder.

def test_preset_steady_ladder_degrades_to_transient_finals(monkeypatch):
    """A steady solve that fails on every rung: the sweep keeps the
    transient finals and records the JAX package's ``transient-fallback``
    event after the ladder's rungs (no requeue without a second card)."""
    from pycatkin_tpu_torch.api import presets
    from torch_toy import toy

    p = toy("pycatkin_tpu_torch", device="cpu")
    Ts = [500.0]
    # The transient is not under test: a stand-in whose finals are the
    # start state keeps the case to the ladder.
    y0 = torch.as_tensor(p.conditions().y0, dtype=torch.float64)
    monkeypatch.setattr(
        presets, "batch_transient",
        lambda spec, conds, grid, opts, device: (
            y0.expand(len(conds.T), 2, -1).clone(),
            torch.ones(len(conds.T), dtype=torch.bool)))
    plan = FaultPlan([{"site": "preset:steady", "kind": "permanent",
                       "times": None}])
    fast = DegradationPolicy(base_delay_s=0.001, max_delay_s=0.002)
    monkeypatch.setattr(
        presets, "run_chunk_with_ladder",
        lambda run, **kw: run_chunk_with_ladder(run, policy=fast, **kw))
    profiling.drain_events()
    with fault_scope(plan):
        finals, _, _ = presets.run_temperatures(p, Ts,
                                                steady_state_solve=True)
    evs = profiling.drain_events()
    rungs = [e["rung"] for e in evs if e["kind"] == "degradation"]
    assert rungs == ["retry", "host-fallback", "host-fallback", "salvage",
                     "transient-fallback"]
    fb = evs[-1]
    assert fb["label"] == "preset:steady" and fb["lanes"] == [0]
    np.testing.assert_array_equal(np.asarray(finals), y0[None].numpy())
