"""The port's cycle pipeline on the CPU: its batch-rung and mega-batch
helpers against the reference's, the launch shapes it cuts, the staging
layer's CPU path, the build count and prewarm, and streamed launches
equal to the barriered path at small fire rungs."""
import numpy as np
import pytest
import torch

from foremast_tpu.engine.analyzer import Analyzer as JaxAnalyzer
from foremast_tpu_torch import engine as E
from foremast_tpu_torch.engine.analyzer import Analyzer, _concat_trimmed
from foremast_tpu_torch.engine.pipeline import prewarm
from foremast_tpu_torch.engine.staging import Staging
from foremast_tpu_torch.kernels import build as kernel_build
from foremast_tpu_torch.ops.windowing import Window

from test_torch_engine import run_port  # noqa: E402


@pytest.mark.parametrize("cap", [16, 1024, 8192, 50000])
def test_rung_ladder_matches_the_reference(cap):
    for n in (1, 15, 16, 17, 63, 64, 200, 511, 513, 1023, 1025, 4000, 9000, 70000):
        assert Analyzer._rung_for(n, cap) == JaxAnalyzer._rung_for(n, cap), (n, cap)


def test_mega_classes_and_caps_match_the_reference():
    for n in list(range(1, 600, 7)) + [1000, 1500, 4096, 5000, 33333, 100_000]:
        assert Analyzer._mega_rows(n) == JaxAnalyzer._mega_rows(n), n
    an = Analyzer(E.EngineConfig(megabatch_max_rows=40000), None, E.JobStore(), device="cpu")
    ref = JaxAnalyzer.__new__(JaxAnalyzer)
    ref.config = an.config
    for T in (16, 128, 1024, 2048, 4096, 16384):
        assert an._mega_cap(T) == JaxAnalyzer._mega_cap(ref, T), T


def test_launch_chunks_pad_to_the_rung_with_the_last_row():
    an = Analyzer(E.EngineConfig(score_batch=64), None, E.JobStore(), device="cpu")
    seen = []

    def pack(h, lo, hi):
        for j in range(hi - lo):
            h["x"][j] = lo + j

    def launch(d):
        seen.append(d["x"].clone())
        return {"y": d["x"] * 2}

    specs = (("x", torch.float32, None),)
    launches = an._launch_chunks("t", 16, 70, specs, pack, launch, ("y",))
    assert [n for _, _, n in launches] == [64, 6]
    assert [len(x) for x in seen] == [64, 16]  # the tail pads to the 16 rung
    assert torch.equal(seen[1][5:], torch.full((11,), 69.0))  # with its last row
    out = an._collect_chunks(launches)
    np.testing.assert_array_equal(out["y"], 2 * np.arange(70, dtype=np.float32))
    assert an.device_launches == 2


def test_staging_on_the_cpu_hands_out_fresh_plain_buffers():
    st = Staging(torch.device("cpu"))
    specs = (("x", torch.float32, "T"), ("m", torch.bool, None), ("p", torch.int32, 4))
    a = st.pack(("k", 8, 16), specs, 16, 8)
    assert {k: v.shape for k, v in a.host.items()} == {"x": (16, 8), "m": (16,), "p": (16, 4)}
    assert not a.tensors["x"].is_pinned()
    a.host["x"][:] = 1.0
    b = st.pack(("k", 8, 16), specs, 16, 8)
    assert float(b.host["x"].sum()) == 0.0  # not the buffer the first launch still holds
    dev = st.to_device(a)
    assert dev["x"] is a.tensors["x"]
    out = st.fetch(("k", 8, 16), {"y": dev["x"] + 1})
    assert float(out["y"].sum()) == 2 * 16 * 8


def test_band_packing_keeps_the_reference_concat():
    rng = np.random.default_rng(2)
    hist = Window(rng.normal(size=20000).astype(np.float32), rng.random(20000) > 0.1, 0)
    cur = Window(rng.normal(size=60).astype(np.float32), np.ones(60, bool), 0)
    from foremast_tpu.engine.analyzer import _concat_trimmed as jax_concat

    for a, b in zip(_concat_trimmed(hist, cur), jax_concat(hist, cur)):
        np.testing.assert_array_equal(a, b)


def test_build_counter_counts_builds_only(monkeypatch, tmp_path):
    """kernels.build.builds counts compiles only: a library already built
    for these sources loads without counting, and prewarm reports the
    builds made while it ran."""
    from foremast_tpu_torch.parallel import fleet

    so = tmp_path / "libforemast_kernels.so"
    so.write_bytes(b"")
    monkeypatch.setattr(kernel_build, "library_path", lambda: str(so))
    monkeypatch.setattr(kernel_build, "builds", kernel_build.builds)
    before = kernel_build.builds
    assert kernel_build.build() == str(so)
    assert kernel_build.builds == before
    real = fleet.score_pairs

    def building(*args, **kwargs):
        kernel_build.builds += 2  # what two builds of the library record
        return real(*args, **kwargs)

    monkeypatch.setattr(fleet, "score_pairs", building)
    assert prewarm(E.EngineConfig(), device="cpu")["builds"] == 2


def test_prewarm_on_the_cpu_runs_each_family_once_and_builds_nothing():
    out = prewarm(E.EngineConfig(), device="cpu")
    assert out["families"] == ["pair", "band", "bivariate", "hpa", "triage"]
    assert out["builds"] == 0 and out["launches"] == {}  # twins: no kernel launched
    with pytest.raises(TypeError):
        prewarm(object(), device="cpu")


def test_streamed_launches_equal_the_barriered_path_at_small_rungs():
    an, _, streamed = run_port(score_pipeline=True, pipeline_fire_rows=16)
    _, _, one_shot = run_port(score_pipeline=True, pipeline_fire_rows=8192)
    _, _, barriered = run_port(score_pipeline=False)
    assert streamed == one_shot == barriered
    fam = an.last_cycle_stages["family_launches"]
    assert fam.get("pair", 0) >= 2  # the 16-row rung really streamed


def test_pipeline_retries_a_failed_launch_per_job(monkeypatch):
    calls = {"n": 0}
    real = Analyzer._launch_pairs

    def flaky(self, group, T):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("launch refused")
        return real(self, group, T)

    monkeypatch.setattr(Analyzer, "_launch_pairs", flaky)
    _, store, digests = run_port()
    monkeypatch.undo()
    _, _, clean = run_port()
    assert digests == clean  # the per-job retry scored every job of the group
    assert calls["n"] > 1
    assert not any(d.reason.startswith("scoring failed")
                   for d in store.by_status(*E.jobs.TERMINAL_STATUSES, *E.jobs.OPEN_STATUSES))
