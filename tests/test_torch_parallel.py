"""Port parity: foremast_tpu_torch.parallel (the mesh, the distributed knobs,
make_fleet_scorer, fleet_summary) and models.lstm_ae.param_shardings,
against the reference on conftest's 8 virtual CPU devices.

The port runs with device="cpu": a world of one process on gloo (a
HashStore), and once a world of two gloo processes in a subprocess. Exact:
the per-pair unhealthy flags, the unhealthy total and the top-k indices; the
top-k values are the port's own severities at those indices, bit for bit,
and the reference's within the severity tolerance of tests/test_torch_fleet.py
(the port's p-values differ from the reference's float32 ones by up to 1e-5,
R2). fleet_summary on the same given flags and severities (ties, NaN, signed
zeros, fewer unhealthy rows than k) equals the reference's exactly.
"""
import functools
import json
import logging
import os
import socket
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

jax = pytest.importorskip("jax")

from foremast_tpu.models import lstm_ae as jl  # noqa: E402
from foremast_tpu.parallel import distributed as jd  # noqa: E402
from foremast_tpu.parallel import fleet as jfl  # noqa: E402
from foremast_tpu.parallel import mesh as jm  # noqa: E402
import foremast_tpu.parallel as jpar  # noqa: E402
from foremast_tpu_torch.models import lstm_ae as tl  # noqa: E402
from foremast_tpu_torch.parallel import distributed as td  # noqa: E402
from foremast_tpu_torch.parallel import fleet as tfl  # noqa: E402
from foremast_tpu_torch.parallel import mesh as tm  # noqa: E402
import foremast_tpu_torch.parallel as tpar  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def world():
    """A world of one gloo process for the test, torn down after it."""
    assert not dist.is_initialized()
    yield tm.fleet_mesh(device="cpu")
    dist.destroy_process_group()


def _batch(B=64, T=32, seed=0):
    """Pairs with every fifth current shifted hard (p clamped at 1e-12: the
    severities tie at 12 plus the band fraction), 10% masked slots."""
    rng = np.random.default_rng(seed)
    base = rng.normal(10, 1, (B, T)).astype(np.float32)
    cur = base + rng.normal(0, 1, (B, T)).astype(np.float32)
    cur[::5] += 5.0
    m = rng.random((B, T)) > 0.1
    return base, m, cur, m


def _cfg(B, threshold=0.01):
    return {"pvalue_threshold": np.full(B, threshold, np.float32),
            "test_mask": np.full(B, 15, np.int32), "combine": np.zeros(B, np.int32),
            "ma_window": np.full(B, 10, np.int32), "band_threshold": np.full(B, 3.0, np.float32),
            "bound_mode": np.zeros(B, np.int32), "min_lower_bound": np.zeros(B, np.float32)}


def _sev_tol(ref_min_p, ref_sev):
    """tests/test_torch_fleet.py's severity tolerance: the p tolerance over
    min_p ln 10, plus 1e-5 relative."""
    return 1e-5 / (np.maximum(ref_min_p, 1e-12) * np.log(10)) + 1e-5 * np.abs(ref_sev)


def test_parallel_exports_the_reference_s_names():
    public = {n for n in dir(jpar)
              if not n.startswith("_") and not isinstance(getattr(jpar, n), types.ModuleType)}
    assert len(public) == 9
    assert all(hasattr(tpar, n) for n in public)


def test_fleet_mesh_is_a_fleet_by_model_device_mesh(world):
    assert world.mesh_dim_names == ("fleet", "model")
    assert tuple(world.mesh.shape) == (1, 1) and world.device_type == "cpu"
    assert dist.get_backend() == "gloo"
    with pytest.raises(ValueError, match="not divisible by model_parallel=2"):
        tm.fleet_mesh(model_parallel=2, device="cpu")
    from torch.distributed.tensor import Replicate, Shard
    assert tm.fleet_sharding(world) == (Shard(0), Replicate())
    assert tm.replicated(world) == (Replicate(), Replicate())


@pytest.mark.parametrize("B,multiple", [(10, 4), (8, 4), (3, 8)])
def test_pad_to_multiple_matches_reference(B, multiple):
    a = np.arange(B * 3, dtype=np.float32).reshape(B, 3)
    b = np.ones(B, bool)
    got, gb = tm.pad_to_multiple([a, b], multiple)
    want, wb = jm.pad_to_multiple([a, b], multiple)
    assert gb == wb
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("B,n,pid", [(64, 4, 0), (64, 4, 3), (12, 3, 2), (10, 4, 1)])
def test_process_batch_slice_matches_reference(B, n, pid):
    ti = td.HostInfo(process_id=pid, num_processes=n, local_devices=1, global_devices=n)
    ji = jd.HostInfo(process_id=pid, num_processes=n, local_devices=1, global_devices=n)
    if B % n:
        with pytest.raises(ValueError, match="not divisible"):
            td.process_batch_slice(B, ti)
        with pytest.raises(ValueError, match="not divisible"):
            jd.process_batch_slice(B, ji)
    else:
        assert td.process_batch_slice(B, ti) == jd.process_batch_slice(B, ji)


def test_initialize_single_host_and_partial_config_stay_local(caplog):
    assert not dist.is_initialized()
    assert td.initialize(env={}) is False
    with caplog.at_level(logging.WARNING, logger="foremast_tpu_torch.parallel"):
        assert td.initialize(env={"COORDINATOR_ADDRESS": "localhost:1"}) is False
    assert "incomplete multi-process config" in caplog.text
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        assert td.initialize(env={"COORDINATOR_ADDRESS": "localhost:1",
                                  "NUM_PROCESSES": "garbage"}) is False
    assert "ignoring invalid NUM_PROCESSES" in caplog.text
    assert td.initialize(env={"NUM_PROCESSES": "4"}) is False
    assert not dist.is_initialized()


@pytest.mark.parametrize("env,want", [
    ({}, ("", None)),
    ({"NUM_PROCESSES": "3", "PROCESS_ID": "1"}, ("proc-1", ["proc-0", "proc-1", "proc-2"])),
    ({"NUM_PROCESSES": "garbage", "PROCESS_ID": "1"}, ("", None)),
    ({"NUM_PROCESSES": "2"}, ("", None)),
])
def test_replica_identity_and_host_info_from_the_knobs(env, want):
    assert td.replica_identity(env) == want == jd.replica_identity(env)
    info = td.host_info(env)
    n = len(want[1]) if want[1] else 1
    assert (info.num_processes, info.process_id) == (n, int(env["PROCESS_ID"]) if n > 1 else 0)


def test_host_info_reads_the_live_world(world):
    info = td.host_info({"NUM_PROCESSES": "5", "PROCESS_ID": "2"})
    assert info == td.HostInfo(process_id=0, num_processes=1, local_devices=1, global_devices=1)
    assert td.initialize(env={"COORDINATOR_ADDRESS": "localhost:1", "NUM_PROCESSES": "2",
                              "PROCESS_ID": "0"}) is False  # already in a world


@pytest.mark.parametrize("k", [1, 8, 64])
def test_fleet_scorer_matches_the_reference_s_eight_device_mesh(world, k):
    B = 64
    base, m, cur, cm = _batch(B)
    cfg = _cfg(B)
    ro, rt, rv, ri = jfl.make_fleet_scorer(jm.fleet_mesh(), k=k)(base, m, cur, cm, cfg)
    out, total, v, i = tfl.make_fleet_scorer(world, k=k)(base, m, cur, cm, cfg)
    np.testing.assert_array_equal(out["unhealthy"].numpy(), np.asarray(ro["unhealthy"]))
    assert isinstance(total, int) and total == rt
    assert v.shape == (min(k, B),) and i.dtype == torch.int64
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    assert torch.equal(v, torch.where(out["unhealthy"], out["severity"], -torch.inf)[i])
    rv = np.asarray(rv)
    tol = _sev_tol(np.asarray(ro["min_p"])[np.asarray(ri)], rv)
    fin = np.isfinite(rv)
    assert np.all(np.abs(v.numpy()[fin] - rv[fin]) <= tol[fin])
    np.testing.assert_array_equal(v.numpy()[~fin], rv[~fin])


def test_fleet_scorer_with_fewer_unhealthy_rows_than_k(world):
    B = 32
    base, m, cur, cm = _batch(B, seed=3)
    cur[:] = base  # nothing shifted: at most a few unhealthy rows
    cur[[4, 9]] += 6.0
    cfg = _cfg(B, threshold=1e-6)
    ro, rt, rv, ri = jfl.make_fleet_scorer(jm.fleet_mesh(), k=8)(base, m, cur, cm, cfg)
    out, total, v, i = tfl.make_fleet_scorer(world, k=8)(base, m, cur, cm, cfg)
    assert total == rt == 2
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    # the -inf tail carries the lowest healthy indices, as lax.top_k
    assert i.tolist()[2:] == [0, 1, 2, 3, 5, 6] and bool(torch.isinf(v[2:]).all())


def _given(B=64, seed=11):
    """Flags and severities with ties (12 + 0 or 0.5), +NaN, signed zeros
    and +-inf among the unhealthy rows."""
    rng = np.random.default_rng(seed)
    u = rng.random(B) < 0.4
    s = rng.uniform(0, 14, B).astype(np.float32)
    tie = rng.random(B) < 0.4
    s[tie] = np.float32(12.0) + np.where(rng.random(int(tie.sum())) < 0.5, 0.0, 0.5)
    s[[3, 17]] = np.nan
    s[[5, 6]] = [0.0, -0.0]
    s[[7, 8]] = [np.inf, -np.inf]
    u[[3, 5, 6, 7, 8, 17]] = True
    return u, s


@pytest.mark.parametrize("k", [1, 8, 64])
@pytest.mark.parametrize("few", [False, True])
def test_fleet_summary_matches_the_reference_exactly(world, k, few):
    u, s = _given()
    if few:
        u[:] = False
        u[[20, 40, 41]] = True
    rt, rv, ri = jfl.fleet_summary(u, s, jm.fleet_mesh(), k=k)
    total, v, i = tfl.fleet_summary(u, s, world, k=k)
    assert total == int(rt)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(v.numpy().view(np.int32), np.asarray(rv).view(np.int32))


@pytest.mark.parametrize("k", [1, 5, 64, 100])
def test_fleet_topk_twin_is_a_stable_total_order_top_k(k):
    u, s = _given(B=80, seed=k)
    count, v, i = tfl.fleet_topk_plain(torch.from_numpy(s), k, torch.from_numpy(u), base=3)
    masked = np.where(u, s, -np.inf).astype(np.float32)
    rv, ri = jax.lax.top_k(masked, min(k, 80))
    assert int(count) == u.sum()
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri) + 3)
    np.testing.assert_array_equal(v.numpy().view(np.int32), np.asarray(rv).view(np.int32))


def test_a_world_of_one_accepts_its_one_slice(world):
    # a world of one holds one slice, of any length; the refusal of unequal
    # slices needs the gather of every slice's length, tested in the
    # two-process run below
    base, m, cur, cm = _batch(7)
    out, total, v, i = tfl.make_fleet_scorer(world, k=3)(base, m, cur, cm, _cfg(7))
    assert v.shape == (3,) and total == int(out["unhealthy"].sum())


_WORKER = r"""
import json, sys
import numpy as np
sys.path.insert(0, {repo!r})
from foremast_tpu_torch.parallel import distributed as D
from foremast_tpu_torch.parallel import fleet as fl

pid = int(sys.argv[1])
assert D.initialize(coordinator="localhost:" + sys.argv[2], num_processes=2, process_id=pid,
                    device="cpu"), "initialize() must join the 2-process world"
info = D.host_info()
mesh = D.global_fleet_mesh(device="cpu")
base, m, cur, cm, cfg, k = (np.load({data!r}, allow_pickle=True)[n] for n in
                            ("base", "m", "cur", "cm", "cfg", "k"))
cfg, k = cfg.item(), int(k)
sl = D.process_batch_slice(base.shape[0], info)
run = fl.make_fleet_scorer(mesh, k=k)
out, total, v, i = run(base[sl], m[sl], cur[sl], cm[sl], {{n: a[sl] for n, a in cfg.items()}})
summary = fl.fleet_summary(out["unhealthy"], out["severity"], mesh, k=k)
try:
    run(base[sl][: 4 + pid], m[sl][: 4 + pid], cur[sl][: 4 + pid], cm[sl][: 4 + pid],
        {{n: a[sl][: 4 + pid] for n, a in cfg.items()}})
    unequal = "accepted"
except ValueError as e:
    unequal = str(e)
print("RESULT " + json.dumps({{
    "pid": pid, "info": [info.process_id, info.num_processes], "slice": [sl.start, sl.stop],
    "unhealthy": out["unhealthy"].tolist(), "total": total, "v": v.tolist(), "i": i.tolist(),
    "summary": [summary[0], summary[2].tolist()], "unequal": unequal}}), flush=True)
import torch.distributed as dist
dist.barrier()
dist.destroy_process_group()
sys.stdout.flush()
import os
os._exit(0)  # past the destroy: gloo's threads need no interpreter teardown
"""


def test_two_process_gloo_fleet_scorer_matches_the_reference(tmp_path):
    """The port's counterpart of tests/test_distributed.py:125-175: the fleet
    scorer across two OS processes joined over gloo (initialize from the
    coordinator, each scoring its process_batch_slice), against the
    reference's 8-device mesh on the whole batch."""
    B, k = 64, 8
    base, m, cur, cm = _batch(B, seed=5)
    cfg = _cfg(B)
    data = str(tmp_path / "batch.npz")
    np.savez(data, base=base, m=m, cur=cur, cm=cm, cfg=np.array(cfg, dtype=object), k=k)
    ro, rt, rv, ri = jfl.make_fleet_scorer(jm.fleet_mesh(), k=k)(base, m, cur, cm, cfg)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    code = _WORKER.format(repo=REPO, data=data)
    env = {**os.environ, "PYTHONPATH": REPO}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(pid), port], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    res = {}
    for text, p in zip(outs, procs):
        assert p.returncode == 0, text[-3000:]
        line = [ln for ln in text.splitlines() if ln.startswith("RESULT ")][-1]
        r = json.loads(line[len("RESULT "):])
        res[r["pid"]] = r
    assert [res[0]["slice"], res[1]["slice"]] == [[0, 32], [32, 64]]
    assert [res[0]["info"], res[1]["info"]] == [[0, 2], [1, 2]]
    np.testing.assert_array_equal(res[0]["unhealthy"] + res[1]["unhealthy"],
                                  np.asarray(ro["unhealthy"]))
    for r in res.values():
        assert r["total"] == int(rt) == r["summary"][0]
        assert r["i"] == np.asarray(ri).tolist() == r["summary"][1]
        rvn = np.asarray(rv)
        tol = _sev_tol(np.asarray(ro["min_p"])[np.asarray(ri)], rvn)
        assert np.all(np.abs(np.asarray(r["v"]) - rvn) <= tol)
        assert "unequal length" in r["unequal"]


def _flax_leaves(tree, prefix=()):
    for name, sub in tree.items():
        if isinstance(sub, dict):
            yield from _flax_leaves(sub, prefix + (name,))
        else:
            yield prefix + (name,), sub


@functools.lru_cache(maxsize=None)
def _reference_params(F, H, Z):
    model = jl.LstmAutoencoder(hidden=H, latent=Z, features=F)
    state, _ = jl.init_state(model, jax.random.PRNGKey(0), 8)
    return state.params.get("params", state.params)


class _Mesh:
    """A (fleet, model) mesh's names and sizes: param_shardings reads only
    these, so a model axis wider than this process's world can be tried."""

    def __init__(self, fleet, model):
        self.mesh_dim_names = ("fleet", "model")
        self._sizes = (fleet, model)

    def size(self, dim):
        return self._sizes[dim]


@pytest.mark.parametrize("mp", [1, 2, 4, 8])
@pytest.mark.parametrize("F,H,Z", [(4, 32, 16), (3, 4, 2), (4, 6, 8)])
def test_param_shardings_follow_the_reference_s_rule(world, F, H, Z, mp):
    from torch.distributed.tensor import Shard

    jmesh = jm.fleet_mesh(model_parallel=mp)
    ref = jl.param_shardings(_reference_params(F, H, Z), jmesh)
    ref_split = {}
    for path, sh in _flax_leaves(jax.tree_util.tree_map(lambda s: s, ref,
                                                        is_leaf=lambda s: hasattr(s, "spec"))):
        spec = tuple(sh.spec)
        ref_split[path] = bool(spec) and spec[-1] == "model"
    port = tl.LstmAutoencoder(hidden=H, latent=Z, features=F)
    mesh = world if mp == 1 else _Mesh(8 // mp, mp)
    got = tl.param_shardings(port, mesh)
    assert set(got) == set(tl.PARAM_NAMES)
    for name, placements in got.items():
        top, leaf = name.split(".")
        if leaf in ("wi", "wh", "b"):
            kind = {"wi": "i", "wh": "h", "b": "h"}[leaf]
            field = "bias" if leaf == "b" else "kernel"
            want = {ref_split[(top, kind + g, field)] for g in "ifgo"}
            assert len(want) == 1
            want = want.pop()
        else:
            want = ref_split[(top, leaf)]
        assert isinstance(placements[1], Shard) == want, name
        assert not isinstance(placements[0], Shard)
