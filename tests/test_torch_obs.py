"""The port's observability, fault injection, retry and I/O helpers against
the JAX package's: the same sequence of counter, gauge and histogram
calls gives the same Prometheus text in both registries; a
``FaultPlan`` fires at the same occurrences of the same sites; the wire
form of a mechanism (``utils.io.system_to_dict``) is the JAX package's
byte for byte; and the port's own contracts -- one counted transfer per
``host_sync`` bundle, the run manifest's keys, no CUDA error
transient, the JSON-lines and ``.npz`` files."""

import json

import numpy as np
import pytest
import torch

from pycatkin_tpu.obs import metrics as jmetrics
from pycatkin_tpu.robustness import faults as jfaults
from pycatkin_tpu_torch.obs import manifest, metrics
from pycatkin_tpu_torch.obs.trace import run_trace
from pycatkin_tpu_torch.robustness import faults
from pycatkin_tpu_torch.utils import io, profiling, retry


def _drive(m):
    """One fixed sequence of instrument calls on registry ``m``."""
    c = m.counter("pycatkin_serve_requests_total", "requests")
    c.inc()
    c.inc(2.0, code="overloaded")
    c.inc(code="bad_request")
    g = m.gauge("pycatkin_serve_queue_depth", "queued")
    g.set(3.0)
    g.inc(-1.0)
    g.set(7.5, bucket="abi-v1:s16")
    h = m.histogram("pycatkin_serve_request_seconds", "walls",
                    buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.5, 5.0):
        h.observe(v, deadline_class="standard")
    h.observe_many(np.array([0.02, 0.2, 2.0]), deadline_class="batch")
    m.histogram("pycatkin_host_sync_seconds").observe(0.3)


def test_prometheus_text_matches_the_jax_registry():
    ours, theirs = metrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    _drive(ours)
    _drive(theirs)
    text = ours.prometheus_text()
    assert text == theirs.prometheus_text()
    assert ours.snapshot() == theirs.snapshot()
    assert metrics.validate_prometheus_text(text) == []
    assert metrics.validate_prometheus_text("bad line\n")
    ours.reset()
    assert ours.snapshot() == {"counters": {}, "gauges": {},
                               "histograms": {}}


def _fired(mod, specs, sites):
    plan = mod.FaultPlan([mod.FaultSpec(**s) for s in specs])
    out = []
    with mod.fault_scope(plan):
        for site in sites:
            try:
                mod.inject(site)
                out.append("ok")
            except Exception as exc:  # noqa: BLE001 -- recorded
                out.append(type(exc).__name__)
            out.append([s.kind for s in mod.take(site)])
    return out, plan.log


def test_fault_plan_fires_at_the_jax_occurrences():
    specs = [dict(site="serve:accept", kind="permanent", index=2),
             dict(site="serve:flush:*", kind="stall", delay_s=0.0,
                  times=2),
             dict(site="serve:flush:abi-v1:s32*", kind="transient",
                  index=1),
             dict(site="router:replica:0", kind="replica-crash", times=None)]
    sites = (["serve:accept"] * 4 + ["serve:flush:abi-v1:s16:r16"] * 2
             + ["serve:flush:abi-v1:s32:r16"] * 3 + ["router:replica:0"] * 2)
    ours, ours_log = _fired(faults, specs, sites)
    theirs, theirs_log = _fired(jfaults, specs, sites)
    assert ours_log == theirs_log
    names = {"InjectedDeviceLossError": "permanent",
             "InjectedTransientError": "transient",
             "JaxRuntimeError": "transient"}
    assert [names.get(o, o) if isinstance(o, str) else o for o in ours] \
        == [names.get(o, o) if isinstance(o, str) else o for o in theirs]
    assert faults.active_plan() is None
    faults.inject("serve:accept")                # no plan: a no-op


def test_nan_fault_poisons_tensor_lanes_and_retry_absorbs_transients():
    plan = faults.FaultPlan([
        faults.FaultSpec(site="run", kind="transient", index=0),
        faults.FaultSpec(site="run", kind="nan", lanes=(1,))])
    calls = []

    def run():
        calls.append(1)
        return {"y": torch.zeros(3, 2), "ok": torch.ones(3, dtype=torch.bool),
                "n": np.zeros(3)}

    with faults.fault_scope(plan):
        out = retry.call_with_backend_retry(run, label="run",
                                            base_delay_s=0.0)
    assert len(calls) == 1          # the first attempt faulted before fn
    assert bool(torch.isnan(out["y"][1]).all())
    assert not bool(torch.isnan(out["y"][[0, 2]]).any())
    assert out["ok"].dtype == torch.bool and bool(out["ok"].all())
    assert np.isnan(out["n"][1]) and not np.isnan(out["n"][0])
    assert [e["kind"] for e in plan.log] == ["transient", "nan"]


def test_only_transport_errors_are_transient():
    assert retry.is_transient_backend_error(ConnectionResetError())
    assert retry.is_transient_backend_error(TimeoutError())
    assert retry.is_transient_backend_error(
        faults.InjectedTransientError("x"))
    # A CUDA error leaves the context lost: never retried.
    for exc in (RuntimeError("CUDA error: an illegal memory access was "
                             "encountered"),
                torch.cuda.OutOfMemoryError("CUDA out of memory"),
                RuntimeError("connection reset"),
                faults.InjectedDeviceLossError("lost")):
        assert not retry.is_transient_backend_error(exc), exc
    with pytest.raises(RuntimeError):
        retry.call_with_backend_retry(
            lambda: (_ for _ in ()).throw(RuntimeError("CUDA error")),
            base_delay_s=0.0)
    assert retry.backoff_delay(3, 0.5, 2.0, jitter=False) == 2.0
    assert retry.backoff_delay(1, 0.5, 2.0, jitter=False) == 1.0


def test_host_sync_moves_a_bundle_once_and_counts_it():
    profiling.reset_sync_count()
    bundle = {"a": torch.arange(5, dtype=torch.float64),
              "b": [torch.tensor([True, False]), None, "s"],
              "c": (torch.zeros(2, 3, dtype=torch.int32), 4)}
    with run_trace("t") as tr, profiling.sync_budget() as b:
        out = profiling.host_sync(bundle, "bundle")
        assert tr.sync_count == 1
    assert b.count == 1 and b.labels == ["bundle"]
    assert profiling.sync_count() == 1
    assert profiling.sync_labels() == ["bundle"]
    np.testing.assert_array_equal(out["a"], np.arange(5.0))
    assert out["b"][0].dtype == np.bool_ and out["b"][1:] == [None, "s"]
    assert out["c"][0].shape == (2, 3) and out["c"][0].dtype == np.int32
    assert int(out["c"][1]) == 4
    assert profiling.reset_sync_count() == 1


def test_events_and_spans_land_in_the_ambient_trace():
    with run_trace("run") as tr:
        profiling.record_event("serve", action="warm", lanes=4)
        with profiling.span("flush", tenants=2):
            pass
        assert [e["kind"] for e in profiling.peek_events()] == \
            ["serve", "span"]
        span = profiling.peek_events("span")[0]
        assert span["label"] == "flush" and span["tenants"] == 2
        assert len(profiling.drain_events()) == 2
        assert tr.peek() == []


def test_run_manifest_has_the_jax_keys_and_the_device():
    from pycatkin_tpu.obs.manifest import run_manifest as jmanifest
    m = manifest.run_manifest(device="cpu")
    assert set(jmanifest()) <= set(m)
    assert m["schema"] == "pycatkin-run-manifest/v1"
    assert m["backend"] == {"platform": "cpu", "device_count": 1,
                            "device_kind": "cpu"}
    assert m["torch"] == torch.__version__
    for key in ("aot_key_version", "program_budget", "cost_ledger",
                "kernel_library", "env"):
        assert m[key] is None, key
    json.dumps(m)


def test_wire_form_is_the_jax_packages(tmp_path):
    from pycatkin_tpu.models.synthetic import synthetic_system_for_bucket \
        as jbucket
    from pycatkin_tpu.utils.io import system_to_dict as jdict
    from pycatkin_tpu_torch.frontend.loader import read_from_input_file
    from pycatkin_tpu_torch.models.synthetic import \
        synthetic_system_for_bucket
    sim = synthetic_system_for_bucket(16, seed=3, device="cpu")
    d = io.system_to_dict(sim)
    assert json.dumps(d, sort_keys=True) == json.dumps(
        jdict(jbucket(16, seed=3)), sort_keys=True)
    path = str(tmp_path / "m.json")
    io.save_system_json(sim, path)
    back = read_from_input_file(path, device="cpu")
    assert back.spec.snames == sim.spec.snames
    np.testing.assert_array_equal(back.spec.stoich, sim.spec.stoich)
    np.testing.assert_array_equal(back.conditions().gelec,
                                  sim.conditions().gelec)


def test_json_lines_and_result_files(tmp_path):
    path = str(tmp_path / "events.jsonl")
    io.append_json_line(path, {"a": 1})
    io.append_json_line(path, {"b": [2, 3]})
    with open(path, "a") as fh:
        fh.write('{"torn": ')                    # a kill mid-append
    assert io.read_json_lines(path) == [{"a": 1}, {"b": [2, 3]}]
    with pytest.raises(json.JSONDecodeError):
        io.read_json_lines(path, tolerate_torn_tail=False)
    io.append_json_line(path, {"c": 4})          # repairs the tail first
    assert io.read_json_lines(path, tolerate_torn_tail=False)[-1] == \
        {"c": 4}
    npz = str(tmp_path / "r.npz")
    io.atomic_save_results(npz, {"y": np.arange(3.0)}, fsync=True)
    np.testing.assert_array_equal(io.load_results(npz)["y"], np.arange(3.0))
    io.save_results(str(tmp_path / "s.npz"), ok=np.array([True]))
    assert io.load_results(str(tmp_path / "s.npz"))["ok"].tolist() == [True]
