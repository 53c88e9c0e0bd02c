"""The port's telemetry (``repro_torch.obs``) against the JAX package's
``repro.obs``, on the CPU: metrics and their snapshot, the windowed
instruments, the tracer and its Chrome export, the comm sink, the SLO
monitor and drift detector, and both engines with a ``Telemetry``.

Every instrument is fed the same observation sequence in both packages and
must read the same (snapshots compare equal after a JSON round trip).
Wall-clock values (latencies, span times) differ between two runs by
nature, so the engine tests compare what does not depend on the clock:
metric names, observation and tick counts, the cache counters behind the
windowed hit rates, and which ticks fire which SLO and drift events.
"""
import dataclasses
import json
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.cache import CacheConfig as JCacheConfig
from repro.configs import dlrm as jcfg_mod
from repro.core import comm as jcomm
from repro.core import perf_model as jpm
from repro.core import sharding_plan as jsp
from repro.data.synthetic import dlrm_drift_batches as jdrift
from repro.models import dlrm as jdlrm
from repro.obs import timeseries as jts
from repro.pipeline import PipelineTrace as JTrace
from repro.serving.engine import CTRRequest as JRequest
from repro.serving.engine import make_dlrm_engine as jmake_engine
from repro_torch import obs
from repro_torch.configs import dlrm as tcfg_mod
from repro_torch.core import comm
from repro_torch.core import perf_model as pm
from repro_torch.core import sharding_plan as sp
from repro_torch.core.cache_config import CacheConfig
from repro_torch.data.synthetic import dlrm_drift_batches
from repro_torch.obs import timeseries as ts
from repro_torch.obs.metrics import LogBuckets
from repro_torch.pipeline import PipelineTrace
from repro_torch.serving.engine import CTRRequest, make_dlrm_engine
from repro_torch.utils.convert import params_from_numpy


def _json(x):
    return json.loads(json.dumps(x))


# ---------------------------------------------------------------------------
# Metrics: the same observations give the same snapshot
# ---------------------------------------------------------------------------

def _feed_registry(mod, rng_seed):
    """One observation sequence, applied to a registry of ``mod``."""
    rng = np.random.default_rng(rng_seed)
    m = mod.MetricsRegistry()
    m.counter("bytes", unit="B").inc(128)
    m.counter("events").inc(3)
    m.gauge("depth").set(7)
    h = m.histogram("lat", unit="s")
    for v in 10.0 ** rng.uniform(-6, 1, 200):
        h.observe(v)
    m.histogram("narrow", lo=1e-3, hi=1.0, buckets_per_decade=4).observe(
        0.05)
    wh = m.windowed_histogram("dlrm.request_latency_s", window=3)
    rc = m.rolling_counter("dlrm.window.hits", window=3)
    ew = m.ewma("dlrm.hit_rate_t", alpha=0.25)
    for _ in range(7):
        for v in 10.0 ** rng.uniform(-5, 0, 5):
            wh.observe(v)
        rc.inc(int(rng.integers(0, 50)))
        ew.update(rng.random(4), mask=rng.random(4) < 0.7)
        m.rotate_windows(prefix="dlrm.")
    m.windowed_histogram("other.queue_depth", unit="1", window=2, lo=0.5,
                         hi=1e7, buckets_per_decade=5).observe(12)
    m.register_producer("dlrm.cache", lambda: {"hits": 7, "lookups": 9})
    return m


@pytest.mark.parametrize("seed", range(3))
def test_snapshot_matches_reference(seed):
    got = _feed_registry(obs, seed)
    want = _feed_registry(jobs, seed)
    assert _json(got.snapshot()) == _json(want.snapshot())
    assert got.SCHEMA_VERSION == want.SCHEMA_VERSION == 2
    assert got.observation_count == want.observation_count
    assert got.windowed_op_counts() == want.windowed_op_counts()


def test_histogram_quantiles_and_bounds():
    for mod in (obs, jobs):
        h = mod.Histogram("lat", buckets_per_decade=20)
        vals = [1e-4 * (1.1 ** i) for i in range(100)]
        for v in vals:
            h.observe(v)
        exact = np.quantile(vals, [0.5, 0.95, 0.99])
        for got, want in zip((h.p50, h.p95, h.p99), exact):
            assert abs(got - want) / want < 0.15
        assert h.min <= h.quantile(0.0) <= h.quantile(1.0) <= h.max
    a, b = obs.Histogram("x"), jobs.Histogram("x")
    for v in (0.0, 1e-9, 3e-4, 2.5, 9e5):
        a.observe(v)
        b.observe(v)
    assert a.to_dict() == b.to_dict()


@pytest.mark.parametrize("bad", [-1.0, float("nan"), float("inf")])
def test_histogram_rejects_bad_values_alike(bad):
    for mod in (obs, jobs):
        h = mod.Histogram("x")
        assert h.quantile(0.5) == 0.0 and h.mean == 0.0
        with pytest.raises(ValueError):
            h.observe(bad)
        with pytest.raises(ValueError):
            h.quantile(1.5)


def test_registry_guards_match_reference():
    for mod in (obs, jobs):
        m = mod.MetricsRegistry()
        m.counter("bytes", unit="B").inc(128)
        with pytest.raises(ValueError, match="unit"):
            m.counter("bytes", unit="1")
        with pytest.raises(ValueError, match="cannot decrease"):
            m.counter("bytes", unit="B").inc(-1)
        m.register_producer("cache", lambda: {"hits": 7})
        with pytest.raises(ValueError, match="already registered"):
            m.register_producer("cache", dict)
        m.register_producer("cache", lambda: {"hits": 9}, replace=True)
        assert m.snapshot()["producers"]["cache"] == {"hits": 9}
        assert set(m.snapshot()) == {"schema_version", "counters", "gauges",
                                     "histograms", "windowed", "rolling",
                                     "ewma", "producers"}


# ---------------------------------------------------------------------------
# Windowed instruments: the reference's property tests, run on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(5))
def test_windowed_quantiles_match_brute_force(seed):
    """The port's ring eviction is indistinguishable from a rebuild, and
    reads what the reference's does on the same sequence."""
    rng = np.random.default_rng(seed)
    window = int(rng.integers(2, 6))
    wh = ts.WindowedHistogram("lat", window=window)
    jwh = jts.WindowedHistogram("lat", window=window)
    ticks = [[]]
    for _ in range(60):
        if rng.random() < 0.3:
            wh.rotate()
            jwh.rotate()
            ticks.append([])
        else:
            v = float(10.0 ** rng.uniform(-6, 2))
            wh.observe(v)
            jwh.observe(v)
            ticks[-1].append(v)
        in_window = [v for tick in ticks[-window:] for v in tick]
        ref = ts.WindowedHistogram("ref", window=window)
        for v in in_window:
            ref.observe(v)
        assert wh.count == ref.count == len(in_window)
        assert wh.total == pytest.approx(ref.total)
        if in_window:
            assert wh.min == min(in_window) and wh.max == max(in_window)
            for q in (0.0, 0.25, 0.5, 0.95, 0.99, 1.0):
                assert wh.quantile(q) == pytest.approx(ref.quantile(q))
        else:
            assert wh.quantile(0.5) == 0.0
        assert wh.to_dict() == jwh.to_dict()


def test_windowed_eviction_and_schema():
    wh = ts.WindowedHistogram("lat", window=2)
    for v in (1e-3, 2e-3, 5e-1, 40.0):
        wh.observe(v)
    wh.rotate()
    wh.rotate()
    assert wh.count == 0 and wh.total == 0.0 and wh.p99 == 0.0
    assert wh.lifetime_count == 4 and wh.rotations == 2
    wh = ts.WindowedHistogram("lat", window=4)
    wh.observe(1e-3)
    wh.rotate()
    d = wh.to_dict()
    assert set(d) == {"unit", "window", "ticks", "count", "sum", "min",
                      "max", "mean", "p50", "p95", "p99",
                      "lifetime_count", "rotations"}
    assert d["window"] == 4 and d["ticks"] == 2
    one = ts.WindowedHistogram("lat", window=3)
    one.observe(3e-3)
    assert one.quantile(0.0) == pytest.approx(3e-3) == one.quantile(1.0)
    with pytest.raises(ValueError):
        ts.WindowedHistogram("x", window=0)
    with pytest.raises(ValueError):
        one.quantile(1.5)
    b = LogBuckets(lo=1e-7, hi=1e4, buckets_per_decade=10)
    assert b.index(0.0) == 0 and b.index(1e9) == b.n - 1
    assert b.edge(1) == pytest.approx(1e-7)


def test_rolling_counter_and_ewma_match_reference():
    rc, jrc = ts.RollingCounter("hits", window=3), \
        jts.RollingCounter("hits", window=3)
    for n in (5, 2, 1, 0, 7):
        for c in (rc, jrc):
            c.inc(n)
            c.rotate()
        assert rc.to_dict() == jrc.to_dict()
    rc = ts.RollingCounter("hits", window=3)
    rc.inc(5)
    rc.rotate()
    rc.inc(2)
    rc.rotate()
    rc.inc(1)
    assert rc.total == 8
    rc.rotate()
    assert rc.total == 3 and rc.rate == pytest.approx(1.0)
    ew = ts.EwmaSeries("hit_rate_t", alpha=0.5)
    assert ew.get() is None
    ew.update(np.array([0.8, 0.4]))
    np.testing.assert_allclose(ew.get(), [0.8, 0.4])
    ew.update(np.array([0.0, 0.9]), mask=np.array([False, True]))
    np.testing.assert_allclose(ew.get(), [0.8, 0.65])
    np.testing.assert_array_equal(ew.updates, [1, 2])
    ew2 = ts.EwmaSeries("x", alpha=0.5)
    ew2.update(np.array([0.3, 0.7]), mask=np.array([True, False]))
    ew2.update(np.array([0.0, 0.9]), mask=np.array([False, True]))
    np.testing.assert_allclose(ew2.get(), [0.3, 0.9])
    with pytest.raises(ValueError):
        ts.EwmaSeries("x", alpha=0.0)


def test_registry_prefix_rotation_and_pins():
    m = obs.MetricsRegistry()
    a = m.windowed_histogram("dlrm.request_latency_s", window=2)
    b = m.windowed_histogram("dlrm_pipelined.request_latency_s", window=2)
    c = m.rolling_counter("dlrm.window.hits", window=2)
    a.observe(1e-3)
    b.observe(1e-3)
    c.inc(1)
    assert m.rotate_windows(prefix="dlrm.") == 2
    assert a.rotations == c.rotations == 1 and b.rotations == 0
    m.ewma("dlrm.hit_rate_t").update(np.array([1.0]))
    assert m.rotate_windows(prefix="dlrm.") == 2
    with pytest.raises(ValueError):
        m.windowed_histogram("dlrm.request_latency_s", window=16)
    with pytest.raises(ValueError):
        m.rolling_counter("dlrm.window.hits", window=8)
    with pytest.raises(ValueError):
        m.ewma("dlrm.hit_rate_t", alpha=0.5)


# ---------------------------------------------------------------------------
# Tracer: Chrome schema, lanes, comm events, stage samples
# ---------------------------------------------------------------------------

def test_tracer_golden_chrome_schema(tmp_path):
    tr = obs.Tracer()
    t = tr.now()
    for lane in obs.LANES:
        tr.add_span(f"{lane}.work", t, t + 1e-3, lane=lane, cat=lane,
                    args={"k": 1})
    with open(tr.export(str(tmp_path / "trace.json"))) as f:
        got = json.load(f)
    assert obs.validate_chrome_trace(got) == len(obs.LANES) * 2
    assert obs.LANES == jobs.LANES
    # the same spans on the reference's tracer export the same events
    jtr = jobs.Tracer()
    jtr.epoch = tr.epoch
    for s in tr.spans():
        jtr.add_span(s.name, s.t0, s.t1, lane=s.lane, cat=s.cat,
                     args=s.args)
    assert got == _json(jtr.to_chrome())
    meta = [e for e in got["traceEvents"] if e["ph"] == "M"]
    assert {e["args"]["name"] for e in meta} == set(obs.LANES)
    xs = [e for e in got["traceEvents"] if e["ph"] == "X"]
    assert all(e["dur"] == pytest.approx(1e3, rel=1e-6) for e in xs)


@pytest.mark.parametrize("bad, match", [
    ([], "traceEvents"),
    ({"traceEvents": [{"ph": "X", "ts": 0, "dur": 0, "pid": 0, "tid": 0}]},
     "name"),
    ({"traceEvents": [{"ph": "B", "ts": 0, "dur": 0, "pid": 0, "tid": 0,
                       "name": "x"}]}, "phase"),
    ({"traceEvents": [{"ph": "X", "ts": -1, "dur": 0, "pid": 0, "tid": 0,
                       "name": "x"}]}, "ts"),
    ({"traceEvents": [{"ph": "X", "ts": 0, "dur": 0, "pid": 0.5, "tid": 0,
                       "name": "x"}]}, "pid"),
])
def test_validate_chrome_trace_rejects_malformed_alike(bad, match):
    with pytest.raises(ValueError, match=match) as got:
        obs.validate_chrome_trace(bad)
    with pytest.raises(ValueError) as want:
        jobs.validate_chrome_trace(bad)
    assert str(got.value) == str(want.value)


def test_tracer_lane_validation_and_disable():
    tr = obs.Tracer()
    with pytest.raises(ValueError, match="lane"):
        tr.add_span("x", 0.0, 1.0, lane="nope")
    off = obs.Tracer(enabled=False)
    off.add_span("x", 0.0, 1.0)
    with off.span("y"):
        pass
    assert off.event_count == 0
    assert not off.add_collective_event(
        comm.CollectiveEvent("fetch_rows", 1, 4, "bulk", 1.0, 2.0))


def test_collective_event_defaults_and_landing():
    ev = comm.CollectiveEvent("all_gather", 1024, 4, "bulk")
    assert (ev.t0, ev.t1) == (0.0, 0.0)
    tr = obs.Tracer()
    assert not tr.add_collective_event(ev)
    assert tr.add_collective_event(
        comm.CollectiveEvent("fetch_rows", 1024, 4, "bulk", 1.0, 1.5))
    (s,) = tr.spans(lane="comm")
    assert s.name == "fetch_rows" and s.seconds == pytest.approx(0.5)
    assert s.args == {"bytes": 1024, "axis_size": 4, "backend": "bulk"}


def test_comm_sink_reaches_background_threads():
    """The port's ``comm.instrument()`` log is thread-local; the tracer's
    sink is process-wide, so a fetch timed on the pipeline's worker
    thread lands on the main thread's timeline."""
    tr = obs.Tracer()
    tr.install_comm_sink()
    try:
        th = threading.Thread(target=lambda: comm.record_runtime(
            "fetch_rows", 4096, 4, "bulk", 1.0, 1.25))
        th.start()
        th.join()
    finally:
        tr.remove_comm_sink()
    (s,) = tr.spans(lane="comm", name="fetch_rows")
    assert s.seconds == pytest.approx(0.25)
    comm.record_runtime("fetch_rows", 1, 2, "bulk", 0.0, 1.0)
    assert tr.event_count == 1


def test_comm_sink_coexists_and_restores():
    tr = obs.Tracer()
    tr.install_comm_sink()
    try:
        with comm.instrument() as ev:
            comm.record_runtime("fetch_rows", 64, 2, "bulk", 2.0, 2.5)
        assert len(ev) == 1 and ev[0].bytes_in == 64
    finally:
        tr.remove_comm_sink()
    assert len(tr.spans(lane="comm")) == 1
    seen = []
    prev = comm.set_event_sink(seen.append)
    tr2 = obs.Tracer()
    tr2.install_comm_sink()
    tr2.install_comm_sink()               # idempotent
    tr2.remove_comm_sink()
    comm.record_runtime("fetch_rows", 1, 2, "bulk", 0.0, 1.0)
    assert len(seen) == 1
    comm.set_event_sink(prev)


def test_pipeline_trace_mirrors_to_tracer():
    tracer = obs.Tracer()
    tr = PipelineTrace(tracer=tracer, label="eng-a")
    tr.record("fetch", 7, 1.0, 2.0)
    with pytest.raises(ValueError, match="unknown stage"):
        tr.record("nope", 0, 0.0, 1.0)
    (s,) = tracer.spans(lane="pipeline")
    assert s.name == "pipeline.fetch"
    assert s.args == {"engine": "eng-a", "batch": 7}
    tracer2 = obs.Tracer()
    assert tracer2.add_pipeline_trace(tr, label="late") == 1
    assert tracer2.spans(lane="pipeline")[0].args["engine"] == "late"
    # the reference's offline path reads the port's trace the same way
    jtracer = jobs.Tracer()
    assert jtracer.add_pipeline_trace(tr, label="late") == 1
    jt = JTrace()
    jt.record("fetch", 7, 1.0, 2.0)
    assert tracer2.add_pipeline_trace(jt, since=1.5) == 0


def test_stage_samples_match_reference():
    """The same cache spans and collective events project onto the same
    StageSamples in both packages, and calibrate reads them alike."""
    spans = [
        ("cache.admit", 0.0, 0.1, "cache", {"tier": "host"}),
        ("cache.fetch", 0.1, 0.3, "cache",
         {"seq": 1, "bytes": 4096, "tier": "host"}),
        ("cache.scatter", 0.3, 0.35, "cache",
         {"seq": 1, "bytes": 4096, "tier": "host"}),
        ("cache.fetch", 1.0, 1.4, "cache",
         {"seq": 2, "bytes": 65536, "tier": "remote"}),
        ("cache.scatter", 1.4, 1.5, "cache",
         {"seq": 2, "bytes": 65536, "tier": "remote"}),
        ("cache.fetch", 2.0, 2.0, "cache",
         {"seq": 3, "bytes": 0, "tier": "host"}),
    ]
    events = [("fetch_rows", 4 * 65536, 4, "onesided", 1.0, 1.3),
              ("fetch_rows", 4 * 1024, 4, "bulk", 2.0, 2.0),
              ("all_to_all", 10, 4, "bulk", 3.0, 3.2),
              ("fetch_rows", 512, 1, "bulk", 4.0, 4.5)]
    out = []
    for mod, cmod in ((obs, comm), (jobs, jcomm)):
        tr = mod.Tracer()
        for name, t0, t1, lane, args in spans:
            tr.add_span(name, t0, t1, lane=lane, cat=lane, args=args)
        for ev in events:
            tr.add_collective_event(cmod.CollectiveEvent(*ev))
        out.append(tr)
    got, want = (tr.stage_samples() for tr in out)
    assert [dataclasses.astuple(s) for s in got] == \
        [dataclasses.astuple(s) for s in want]
    assert sorted(s.stage for s in got) == ["fetch_remote", "h2d", "h2d"]
    assert [dataclasses.astuple(s) for s in out[0].stage_samples(since=0.9)]\
        == [dataclasses.astuple(s) for s in out[1].stage_samples(since=0.9)]
    res, jres = pm.calibrate(out[0], onesided=True), \
        jpm.calibrate(out[1], onesided=True)
    assert (res.n_h2d, res.n_remote) == (jres.n_h2d, jres.n_remote) == (2, 1)
    assert dataclasses.asdict(res.hw) == dataclasses.asdict(jres.hw)


# ---------------------------------------------------------------------------
# SLO monitor and drift detector, fed by hand
# ---------------------------------------------------------------------------

def _feed_window(tel, engine="dlrm", *, latencies=(), hits=0, lookups=0,
                 depth=None):
    m, w = tel.metrics, tel.window
    for v in latencies:
        m.windowed_histogram(f"{engine}.request_latency_s", unit="s",
                             window=w).observe(v)
    if lookups:
        m.rolling_counter(f"{engine}.window.hits", window=w).inc(hits)
        m.rolling_counter(f"{engine}.window.lookups", window=w).inc(lookups)
    if depth is not None:
        m.windowed_histogram(f"{engine}.queue_depth", unit="1", window=w,
                             lo=0.5, hi=1e7,
                             buckets_per_decade=5).observe(depth)


def _slo_run(mod, script):
    """Apply ``script`` (a list of window feeds) to a monitor and a drift
    detector of ``mod``; returns their event dicts and summaries."""
    tel = mod.Telemetry(window=4)
    mon = mod.SLOMonitor(tel, mod.SLOPolicy(
        name="tight", p99_budget_s=1e-3, hit_rate_floor=0.9,
        queue_depth_cap=10, min_window_count=2, min_window_lookups=5),
        stride=1)
    det = mod.DriftDetector(tel, [0.9, 0.9], threshold=0.2, min_updates=2)
    for feed, rates in script:
        _feed_window(tel, **feed)
        if rates is not None:
            r = np.asarray(rates, np.float64)
            tel.metrics.ewma("dlrm.hit_rate_t").update(r, mask=r >= 0)
        tel.batch_tick("dlrm")
    spans = [(s.name, s.args) for s in tel.tracer.spans(lane="slo")]
    return ([e.to_dict() for e in mon.events], mon.summary(),
            [e.to_dict() for e in det.events], det.summary(), spans)


def test_monitor_and_detector_fire_alike():
    script = [
        (dict(latencies=[5e-3, 6e-3], hits=5, lookups=10, depth=64),
         [0.9, 0.9]),
        (dict(latencies=[1e-4], hits=9, lookups=10, depth=2), [0.9, 0.9]),
        (dict(latencies=[1e-4, 2e-4], hits=1, lookups=3), [0.9, 0.9]),
        (dict(latencies=[1e-4, 1e-4], hits=10, lookups=10), [0.0, 0.9]),
        (dict(), [0.0, -1.0]),
        (dict(), [0.0, 0.9]),
        (dict(hits=0, lookups=20), [0.9, 0.9]),
        (dict(), [0.9, 0.9]),
        (dict(), [0.9, 0.9]),
        (dict(), [0.0, 0.1]),
        (dict(), [0.0, 0.1]),
    ]
    got, want = _slo_run(obs, script), _slo_run(jobs, script)
    assert _json(got) == _json(want)
    mon_events, _, det_events, det_summary, _ = got
    assert mon_events and det_events
    assert det_summary["first_detection_tick"] is not None


def test_slo_guards_match_reference():
    for mod in (obs, jobs):
        tel = mod.Telemetry(window=4)
        with pytest.raises(ValueError):
            mod.SLOMonitor(tel, mod.SLOPolicy(), stride=0)
        with pytest.raises(ValueError):
            mod.DriftDetector(tel, [0.5], threshold=0.0)
        mod.DriftDetector(tel, [0.9, 0.9, 0.9])
        tel.metrics.ewma("dlrm.hit_rate_t").update(np.array([0.5, 0.5]))
        with pytest.raises(ValueError, match="shape"):
            tel.batch_tick("dlrm")


def test_expected_hit_rates_from_plan_match():
    args = dict(num_shards=2, batch_per_shard=8, hbm_budget_bytes=48_000,
                zipf_a=0.9)
    got = obs.expected_hit_rates(sp.plan(
        [sp.TableSpec(f"t{i}", 2048, 16, 8) for i in range(6)],
        hw=pm.H100_DGX, **args), 6)
    want = jobs.expected_hit_rates(jsp.plan(
        [jsp.TableSpec(f"t{i}", 2048, 16, 8) for i in range(6)],
        hw=jpm.H100_DGX, **args), 6)
    np.testing.assert_array_equal(got, want)
    assert ((got > 0) & (got < 1)).all()


# ---------------------------------------------------------------------------
# Exporters
# ---------------------------------------------------------------------------

def test_sweep_report_matches_reference(tmp_path):
    for mod in (obs, jobs):
        rep = mod.SweepReport("sweep", "x", "y")
        rep.add(sweep="s", x=1, y=2.5)
        rep.comment("context line")
        rep.add(sweep="s", x=3, y="0.125")
        assert len(rep) == 2
        assert rep.csv() == \
            "sweep,x,y\ns,1,2.5\n# context line\ns,3,0.125\n"
        with pytest.raises(ValueError, match="missing"):
            rep.add(sweep="s", x=1)
        with pytest.raises(ValueError, match="unexpected"):
            rep.add(sweep="s", x=1, y=2, z=3)
        with pytest.raises(ValueError, match="duplicate"):
            mod.SweepReport("a", "a")
    text = open(rep.write(str(tmp_path / "ref.csv"))).read()
    port = obs.SweepReport("sweep", "x", "y")
    port.add(sweep="s", x=1, y=2.5)
    body = open(port.write(str(tmp_path / "out.csv"))).read()
    header, rest = body.split("# torch_version:", 1)
    assert header.startswith("# git_sha:") and "# timestamp_utc:" in header
    assert rest.split("\n", 1)[1] == port.csv()
    assert text.startswith("# git_sha:")


def test_write_snapshot(tmp_path):
    m = obs.MetricsRegistry()
    m.histogram("lat").observe(0.5)
    path = obs.write_snapshot(str(tmp_path / "snap.json"), metrics=m,
                              extra={"calibration": {"host_Bps": 1e8}})
    with open(path) as f:
        got = json.load(f)
    assert got["schema_version"] == 2
    assert set(got["provenance"]) == {"git_sha", "timestamp_utc",
                                      "torch_version"}
    assert got["provenance"]["torch_version"] == torch.__version__
    assert got["metrics"] == _json(m.snapshot())
    assert got["calibration"] == {"host_Bps": 1e8}


# ---------------------------------------------------------------------------
# Both engines with a Telemetry, against the reference's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jcfg_mod.smoke(), kernel_mode="reference")
    jparams = jdlrm.init_params(jax.random.key(0), jcfg)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu")
    return jcfg, jparams, tcfg_mod.smoke(), params


def _zipf_requests(cfg, n, seed):
    T, L, F = cfg.num_sparse_features, cfg.pooling, cfg.num_dense_features
    rng = np.random.default_rng(seed)
    return [dict(rid=rid, dense=rng.standard_normal(F).astype(np.float32),
                 indices=np.minimum(rng.zipf(1.2, size=(T, L)) - 1,
                                    cfg.rows_per_table - 1).astype(np.int32),
                 lengths=np.full(T, L, np.int32)) for rid in range(n)]


def _run(make, params, cfg, cls, reqs, tel, **kw):
    eng = make(params, cfg, 4, telemetry=tel, **kw)
    for r in reqs:
        eng.submit(cls(**r))
    out = eng.run_to_completion()
    return eng, out


def _clockless(snap, pipelined):
    """A snapshot's structure without its clock readings: names, units,
    counts, windows, cache counters.  Under the pipelined engine a
    batch's cache movement is read when its scores are collected, which
    may be before or after the next batch's prefetch lands (the
    reference's one batch of attribution skew, decided by thread timing):
    there only the lifetime totals of the windowed hit counts and the
    EWMA's width are fixed."""
    out = {"schema_version": snap["schema_version"]}
    for sec in ("histograms", "windowed"):
        out[sec] = {k: (v["unit"], v["count"], v.get("window"),
                        v.get("lifetime_count"), v.get("rotations"))
                    for k, v in snap[sec].items()}
    out["rolling"] = {k: (v["lifetime_total"] if pipelined else v)
                      for k, v in snap["rolling"].items()}
    out["ewma"] = {k: (v["n"] if pipelined else v)
                   for k, v in snap["ewma"].items()}
    out["gauges"] = snap["gauges"]
    out["counters"] = snap["counters"]
    out["producers"] = {
        k: {f: x for f, x in v.items()
            if not f.endswith("_s") and "overlap" not in f}
        for k, v in snap["producers"].items()}
    return out


@pytest.mark.parametrize("depth", [1, 2])
def test_engines_with_telemetry_match_reference(models, depth):
    jcfg, jparams, tcfg, params = models
    cache = dict(rows=32, pipeline_depth=depth)
    reqs = _zipf_requests(tcfg, 10, seed=1)
    tel, jtel = obs.Telemetry(), jobs.Telemetry()
    eng, got = _run(make_dlrm_engine, params, dataclasses.replace(
        tcfg, cache=CacheConfig(**cache)), CTRRequest, reqs, tel,
        device="cpu")
    jeng, want = _run(jmake_engine, jparams, dataclasses.replace(
        jcfg, cache=JCacheConfig(**cache)), JRequest, reqs, jtel)
    np.testing.assert_allclose([got[i] for i in range(10)],
                               [want[i] for i in range(10)],
                               rtol=1e-4, atol=1e-5)
    assert eng.obs_name == jeng.obs_name == \
        ("dlrm" if depth == 1 else "dlrm_pipelined")
    assert tel.ticks(eng.obs_name) == jtel.ticks(jeng.obs_name) == 3
    assert _json(_clockless(tel.metrics.snapshot(), depth > 1)) == \
        _json(_clockless(jtel.metrics.snapshot(), depth > 1))
    h = tel.request_latency(eng.obs_name)
    assert h.count == 10 and 0 <= h.p50 <= h.p99 <= h.max
    assert not eng._enqueue_t and not eng._dequeue_t
    for lane in obs.LANES:
        names = sorted(s.name for s in tel.tracer.spans(lane=lane))
        jnames = sorted(s.name for s in jtel.tracer.spans(lane=lane))
        if lane != "cache":
            assert names == jnames, lane
        else:       # one fetch/scatter pair per prefetch that missed
            assert sorted(set(names)) == sorted(set(jnames))
    obs.validate_chrome_trace(tel.tracer.to_chrome())
    bufs = getattr(eng.cache, "buffers", [eng.cache])
    assert all(b.tracer is tel.tracer for b in bufs)
    if depth == 1:
        fw = tel.tracer.spans(lane="engine", name="dlrm.forward")
        pf = tel.tracer.spans(lane="engine", name="dlrm.prefetch")
        assert len(fw) == len(pf) == 3
        fetches = tel.tracer.spans(lane="cache", name="cache.fetch")
        scatters = tel.tracer.spans(lane="cache", name="cache.scatter")
        assert fetches and all(s.args["tier"] == "host" for s in fetches)
        assert {s.args["seq"] for s in fetches} == \
            {s.args["seq"] for s in scatters}
        samples = tel.tracer.stage_samples()
        assert samples and all(s.stage == "h2d" and s.bytes > 0
                               and s.seconds > 0 for s in samples)
        assert len(samples) == len(jtel.tracer.stage_samples())
        prod = tel.metrics.snapshot()["producers"]["dlrm.cache"]
        assert prod["schema_version"] == 3 and prod["lookups"] > 0
    else:
        lane = tel.tracer.spans(lane="pipeline")
        assert len(lane) == len(eng.trace.spans)
        assert {s.name for s in lane} >= {"pipeline.admit", "pipeline.fetch",
                                          "pipeline.scatter",
                                          "pipeline.forward"}
        assert all(s.args["engine"] == "dlrm_pipelined" for s in lane)
        snap = tel.metrics.snapshot()
        for stage in ("admit", "fetch", "scatter", "forward", "swap"):
            name = f"dlrm_pipelined.stage.{stage}_s"
            assert snap["windowed"][name]["lifetime_count"] == 3


def test_request_latency_under_pipelined_requeue_on_failure(models):
    """A pipeline failure requeues every unscored request with its original
    stamp; the retry records each request once."""
    _, _, tcfg, params = models
    cfg = dataclasses.replace(tcfg, cache=CacheConfig(rows=32,
                                                      pipeline_depth=2))
    tel = obs.Telemetry()
    piped = make_dlrm_engine(params, cfg, 4, device="cpu", telemetry=tel)
    for r in _zipf_requests(tcfg, 12, seed=8):
        piped.submit(CTRRequest(**r))
    t_submit = time.perf_counter()
    cold = piped.cache.buffers[0].cold
    real_fetch, calls = cold.fetch, {"n": 0}

    def flaky(t, r):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("transient cold-tier failure")
        return real_fetch(t, r)

    cold.fetch = flaky
    try:
        with pytest.raises(RuntimeError, match="transient"):
            piped.run_to_completion()
    finally:
        cold.fetch = real_fetch
    assert len(piped.queue) == 12
    got = piped.run_to_completion()
    assert sorted(got) == list(range(12))
    h = tel.request_latency(piped.obs_name)
    assert h.count == 12 and not piped._enqueue_t
    spans = tel.tracer.spans(lane="request")
    assert len(spans) == 12 and all(s.t0 <= t_submit for s in spans)


def test_telemetry_disabled_records_nothing(models):
    _, _, tcfg, params = models
    for depth in (1, 2):
        cfg = dataclasses.replace(tcfg, cache=CacheConfig(
            rows=32, pipeline_depth=depth))
        tel = obs.Telemetry(enabled=False)
        assert not tel.enabled
        eng, _ = _run(make_dlrm_engine, params, cfg, CTRRequest,
                      _zipf_requests(tcfg, 4, seed=2), tel, device="cpu")
        assert tel.tracer.event_count == 0
        assert tel.request_latency(eng.obs_name).count == 4


def test_engine_without_telemetry_keeps_no_stamps(models):
    _, _, tcfg, params = models
    cfg = dataclasses.replace(tcfg, cache=CacheConfig(rows=32))
    eng = make_dlrm_engine(params, cfg, 4, device="cpu")
    assert eng.telemetry is None and eng.cache.tracer is None
    for r in _zipf_requests(tcfg, 5, seed=3):
        eng.submit(CTRRequest(**r))
    eng.run_to_completion()
    assert not eng._enqueue_t and not eng._dequeue_t


# ---------------------------------------------------------------------------
# Drift: dlrm_drift_batches, the monitor and the detector over a plan
# ---------------------------------------------------------------------------

# benchmarks/slo_sweep.py's SMOKE shape
DRIFT = dict(tables=6, rows=2048, dim=16, pooling=8, batch=8,
             budget=48_000, window=4, batches=24, rotate_at=12, zipf=0.9)


@pytest.mark.parametrize("rotate_every, fixed", [(0, True), (3, True),
                                                  (2, False)])
def test_drift_batches_match_reference(rotate_every, fixed):
    cfg = dataclasses.replace(tcfg_mod.smoke(), rows_per_table=300)
    jcfg = dataclasses.replace(jcfg_mod.smoke(), rows_per_table=300)
    kw = dict(seed=4, start_step=1, zipf_a=1.05, rotate_every=rotate_every,
              fixed_pooling=fixed)
    got = dlrm_drift_batches(cfg, 5, device="cpu", **kw)
    want = jdrift(jcfg, 5, **kw)
    for _ in range(7):
        g, w = next(got), next(want)
        assert g["phase"] == w["phase"]
        assert g["batch"].indices.dtype == torch.int32
        np.testing.assert_array_equal(g["batch"].indices.numpy(),
                                      np.asarray(w["batch"].indices))
        np.testing.assert_array_equal(g["batch"].lengths.numpy(),
                                      np.asarray(w["batch"].lengths))
        np.testing.assert_array_equal(g["dense"].numpy(), w["dense"])
        np.testing.assert_array_equal(g["labels"].numpy(), w["labels"])


def test_drift_batches_guards_and_device():
    cfg = tcfg_mod.smoke()
    with pytest.raises(ValueError, match="rotate_every"):
        next(dlrm_drift_batches(cfg, 2, rotate_every=-1, device="cpu"))
    with pytest.raises(ValueError, match="rotate_shift"):
        next(dlrm_drift_batches(cfg, 2, rotate_every=2, rotate_shift=0,
                                device="cpu"))
    with pytest.raises(RuntimeError, match="CUDA"):
        next(dlrm_drift_batches(cfg, 2))
    # the stationary control is bitwise the drifting stream's phase 0
    a = dlrm_drift_batches(cfg, 3, rotate_every=0, device="cpu")
    b = dlrm_drift_batches(cfg, 3, rotate_every=4, device="cpu")
    for _ in range(4):
        assert torch.equal(next(a)["batch"].indices,
                           next(b)["batch"].indices)


def _drift_run(port: bool, rotate_every: int, jparams, params):
    """slo_sweep.py's SMOKE run on one package: plan-sized pools warmed on
    phase 0's popularity, a hit-rate SLO and a drift detector."""
    s = DRIFT
    fields = dict(num_sparse_features=s["tables"], rows_per_table=s["rows"],
                  embedding_dim=s["dim"], pooling=s["pooling"],
                  bottom_mlp=(32, s["dim"]))
    mod, smod, hw = (obs, sp, pm.H100_DGX) if port else \
        (jobs, jsp, jpm.H100_DGX)
    specs = [smod.TableSpec(f"t{i}", rows=s["rows"], dim=s["dim"],
                            pooling=s["pooling"]) for i in range(s["tables"])]
    p = smod.plan(specs, num_shards=2, batch_per_shard=s["batch"],
                  hbm_budget_bytes=s["budget"], hw=hw, zipf_a=s["zipf"])
    expected = mod.expected_hit_rates(p, s["tables"])
    freqs = (np.arange(1, s["rows"] + 1, dtype=np.float64)
             ** -s["zipf"]) * 1e7
    tel = mod.Telemetry(window=s["window"])
    if port:
        base = dataclasses.replace(tcfg_mod.smoke(), **fields)
        cfg = dataclasses.replace(base, sharding_plan=p, cache=CacheConfig(
            warmup_freqs=freqs))
        eng = make_dlrm_engine(params, cfg, s["batch"], device="cpu",
                               telemetry=tel)
        gen = dlrm_drift_batches(cfg, s["batch"], seed=3, zipf_a=s["zipf"],
                                 rotate_every=rotate_every, device="cpu")
        cls = CTRRequest
    else:
        base = dataclasses.replace(jcfg_mod.smoke(), kernel_mode="reference",
                                   **fields)
        cfg = dataclasses.replace(base, sharding_plan=p, cache=JCacheConfig(
            warmup_freqs=freqs))
        eng = jmake_engine(jparams, cfg, s["batch"], telemetry=tel)
        gen = jdrift(cfg, s["batch"], seed=3, zipf_a=s["zipf"],
                     rotate_every=rotate_every)
        cls = JRequest
    floor = max(0.05, float(expected.mean()) - 0.15)
    mon = mod.SLOMonitor(tel, mod.SLOPolicy(name="serving",
                                            hit_rate_floor=floor),
                         engine=eng.obs_name)
    det = mod.DriftDetector(tel, expected, engine=eng.obs_name,
                            threshold=0.15, min_updates=3)
    rid = 0
    for _ in range(s["batches"]):
        d = next(gen)
        idx = np.asarray(d["batch"].indices)
        lens = np.asarray(d["batch"].lengths)
        dense = np.asarray(d["dense"])
        for i in range(s["batch"]):
            eng.submit(cls(rid=rid, dense=dense[i],
                           indices=idx[:, i, :].astype(np.int32),
                           lengths=lens[:, i].astype(np.int32)))
            rid += 1
        eng.run_to_completion()
    return ([e.to_dict() for e in mon.events], mon.windows_evaluated,
            [e.to_dict() for e in det.events], det.summary(),
            tel.ticks(eng.obs_name))


@pytest.fixture(scope="module")
def drift_params():
    s = DRIFT
    jcfg = dataclasses.replace(
        jcfg_mod.smoke(), kernel_mode="reference",
        num_sparse_features=s["tables"], rows_per_table=s["rows"],
        embedding_dim=s["dim"], pooling=s["pooling"],
        bottom_mlp=(32, s["dim"]))
    jparams = jdlrm.init_params(jax.random.key(0), jcfg)
    return jparams, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")


@pytest.mark.parametrize("rotate_every", [0, DRIFT["rotate_at"]])
def test_monitor_and_detector_over_drift_fire_alike(drift_params,
                                                    rotate_every):
    """The same ticks fire the same hit-rate breaches and drift events in
    both packages; the stationary control stays quiet and the rotation is
    flagged after it happens."""
    jparams, params = drift_params
    got = _drift_run(True, rotate_every, jparams, params)
    want = _drift_run(False, rotate_every, jparams, params)
    assert _json(got) == _json(want)
    mon_events, windows, det_events, summary, ticks = got
    assert ticks == windows == DRIFT["batches"]
    if rotate_every == 0:
        assert mon_events == [] and det_events == []
    else:
        first = summary["first_detection_tick"]
        assert first is not None and first > DRIFT["rotate_at"]
        assert any(e["rule"] == "hit_rate" for e in mon_events)
