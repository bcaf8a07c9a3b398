"""The port's data plane on the CPU: its own build of the native parser
(foremast_tpu_torch/native, a copy of the reference's source) against its
pure-Python fallback on the bodies of tests/test_native.py, exact; the
port's fetch path against the reference's on the same bodies; and the
exporter's exposition. The native tests skip when no C++ compiler is
installed."""
import json
import shutil

import numpy as np
import pytest

from foremast_tpu.dataplane import fetch as jax_fetch
from foremast_tpu_torch import native
from foremast_tpu_torch.dataplane import fetch as F
from foremast_tpu_torch.dataplane.exporter import VerdictExporter
from foremast_tpu_torch.utils import knobs


@pytest.fixture
def built():
    if shutil.which(knobs.read("CXX")) is None:
        pytest.skip("no C++ compiler: the native parser cannot be built")
    if not native.available():
        pytest.fail("a C++ compiler is installed but the native parser did not build")
    assert "build/foremast_tpu_torch/native" in native.lib_path()


def _prom_payload(series):
    return json.dumps({"status": "success", "data": {"resultType": "matrix", "result": [
        {"metric": {"app": f"s{i}", "pod": "x" * 10},
         "values": [[t, str(v)] for t, v in s]} for i, s in enumerate(series)]}}).encode()


def _py_prom(raw):
    payload = json.loads(raw)
    result = payload.get("data", {}).get("result", [])
    return F._avg_series([[(float(ts), float(v)) for ts, v in item.get("values", [])]
                          for item in result])


def _bodies():
    rng = np.random.default_rng(0)
    base = 1_700_000_000
    t0 = base // 60 * 60
    s1 = [(base + 60 * i + 0.781, float(rng.normal(10, 2))) for i in range(500)]
    s2 = [(base + 60 * i + 0.781, float(rng.normal(5, 1))) for i in range(250)]
    g1 = [(t0 + 60 * i, float(rng.normal())) for i in range(200)]
    g2 = [(t0 + 60 * i + 17, float(rng.normal())) for i in range(0, 200, 3)]
    g2 += g2[:5]  # duplicates, averaged
    special = json.dumps({"status": "success", "data": {"result": [{
        "metric": {"weird \"key\"": "va\\lue\nnewlineé"},
        "values": [[1000, "NaN"], [1060, "+Inf"], [1120, "-Inf"], [1180, "42.5"]]}]}}).encode()
    return {"two series": _prom_payload([s1, s2]), "ragged": _prom_payload([g1, g2]),
            "long": _prom_payload([[(t0 + 60 * i, float(i)) for i in range(2880)]]),
            "special": special, "empty": _prom_payload([])}


@pytest.mark.parametrize("name", ["two series", "ragged", "long", "special", "empty"])
def test_native_parse_series_equals_the_python_fallback(built, name):
    raw = _bodies()[name]
    ts_n, v_n = native.parse_series(raw, native.FLAVOR_PROMETHEUS)
    ts_p, v_p = _py_prom(raw)
    np.testing.assert_array_equal(ts_n, np.asarray(ts_p, np.float64).reshape(-1))
    np.testing.assert_array_equal(v_n, np.asarray(v_p, np.float64).reshape(-1))


@pytest.mark.parametrize("name,max_steps", [("two series", 16384), ("ragged", 16384),
                                            ("long", 1440), ("empty", 16384)])
def test_native_parse_grid_equals_the_python_pipeline(built, name, max_steps):
    raw = _bodies()[name]
    vals, mask, start = native.parse_grid(raw, native.FLAVOR_PROMETHEUS, 60, max_steps)
    want = F.grid_from_series(*_py_prom(raw), 60, max_steps)
    assert start == want.start
    np.testing.assert_array_equal(mask, want.mask)
    np.testing.assert_array_equal(vals, want.values)


@pytest.mark.parametrize("samples", [
    [(-90.5, 1.0), (-30.2, 2.0), (10.0, 3.0)],   # the start below zero
    [(-200.7, 1.0), (-61.0, 2.0)],               # the whole span below zero
    [(-3600.0, 4.0), (-1.0, 5.0), (59.0, 6.0)]])  # on and beside step boundaries
def test_native_parse_grid_floors_a_negative_timestamp(built, samples):
    """The native grid aligns its span as align_step does (int(t), then a
    floor division by the step), so a negative timestamp gives the Python
    path's start, end and slots."""
    raw = _prom_payload([samples])
    vals, mask, start = native.parse_grid(raw, native.FLAVOR_PROMETHEUS, 60, 16384)
    want = F.grid_from_series(*_py_prom(raw), 60, 16384)
    assert start == want.start
    assert len(vals) == len(want.values)
    np.testing.assert_array_equal(mask, want.mask)
    np.testing.assert_array_equal(vals, want.values)


def test_native_refuses_malformed_bodies(built):
    assert native.parse_series(b'{"data": {"result": [', 0) is None
    assert native.parse_series(b"", 0) is None
    assert native.parse_series(b"[" * 200_000, native.FLAVOR_PROMETHEUS) is None
    assert native.parse_grid(b"{nope", native.FLAVOR_PROMETHEUS) is None


def test_resample_native_equals_numpy(built):
    rng = np.random.default_rng(1)
    start, end, step = 0, 1200 * 60, 60
    ts = rng.uniform(-3600, end + 3600, 2000)
    ts[:200] = np.arange(200) * 60 + 30.0  # half-step boundaries
    vals = rng.normal(0, 1, 2000)
    vals[::17] = np.nan
    got = native.resample(ts, vals, start, end, step)
    want = F.resample_to_grid(ts, vals, start, end, step)
    np.testing.assert_array_equal(got[0], want.values)
    np.testing.assert_array_equal(got[1], want.mask)


@pytest.mark.parametrize("name", ["two series", "ragged", "long", "special", "empty"])
def test_raw_fixture_window_equals_the_reference(name):
    """The port's RawFixtureDataSource (parser and grid) gives the
    reference's Window for every body, native or not."""
    raw = _bodies()[name]
    ours = F.RawFixtureDataSource({"u": raw}).fetch_window("u")
    theirs = jax_fetch.RawFixtureDataSource({"u": raw}).fetch_window("u")
    assert (ours.start, ours.step) == (theirs.start, theirs.step)
    np.testing.assert_array_equal(ours.mask, theirs.mask)
    np.testing.assert_array_equal(ours.values, theirs.values)


def test_python_fallback_path_and_error_status(monkeypatch):
    raw = _bodies()["ragged"]
    src = F.RawFixtureDataSource({"u": raw})
    with_native = src.fetch_window("u")
    monkeypatch.setattr(F.native, "parse_grid", lambda *a: None)
    monkeypatch.setattr(F.native, "parse_series", lambda *a: None)
    fallback = src.fetch_window("u")
    np.testing.assert_array_equal(with_native.values, fallback.values)
    np.testing.assert_array_equal(with_native.mask, fallback.mask)
    err = F.RawFixtureDataSource({"u": json.dumps({"status": "error"}).encode()})
    with pytest.raises(F.FetchError):
        err.fetch("u")
    with pytest.raises(F.FetchError):
        F.RawFixtureDataSource({}).fetch("missing")


def test_exporter_renders_counters_gauges_and_histograms():
    ex = VerdictExporter()
    ex.record_counter("foremastbrain:triage_screened_total", {"family": "band"}, 3,
                      help="rows screened")
    ex.record_gauge("foremastbrain:triage_seconds", {}, 0.5, help="seconds")
    ex.record_bounds("app", "ns", "latency", 2.0, 1.0, 0.0)
    ex.record_histogram("foremastbrain:cycle_seconds", {}, 0.3)
    text = ex.render()
    assert 'foremastbrain:triage_screened_total{family="band"} 3.0' in text
    assert "# TYPE foremastbrain:triage_screened_total counter" in text
    assert "foremastbrain:triage_seconds 0.5" in text
    assert 'foremastbrain:latency_upper{app="app",namespace="ns"} 2.0' in text
    assert 'foremastbrain:cycle_seconds_bucket{le="0.5"} 1' in text
    assert "foremastbrain:cycle_seconds_count 1" in text
