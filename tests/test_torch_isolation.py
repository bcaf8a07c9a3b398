"""The port stands alone: foremast_tpu_torch imports neither JAX nor any
module of foremast_tpu, and its entry points never drift onto the CPU."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import foremast_tpu_torch
from foremast_tpu_torch.ops import forecast as tfc
from foremast_tpu_torch.ops import seqscan as tsq
from foremast_tpu_torch.parallel import fleet as tfl

PKG = os.path.dirname(os.path.abspath(foremast_tpu_torch.__file__))
REPO = os.path.dirname(PKG)


def _py_files():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "optax") or top == "foremast_tpu"


def test_no_file_of_the_port_imports_jax_or_the_reference():
    files = list(_py_files())
    assert len(files) >= 10
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert not _forbidden(n), f"{path} imports {n}"


def test_importing_the_port_loads_no_jax_or_reference_module():
    # a finder that refuses the reference and JAX, ahead of every other
    code = (
        "import sys\n"
        "class Refuse:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'foremast_tpu'):\n"
        "            raise ImportError('the port imported ' + name)\n"
        "sys.meta_path.insert(0, Refuse())\n"
        "before = set(sys.modules)\n"
        "import foremast_tpu_torch.parallel.fleet, foremast_tpu_torch.ops.forecast\n"
        "import foremast_tpu_torch.ops.windowing, foremast_tpu_torch.kernels\n"
        "import foremast_tpu_torch.ops.seqscan, foremast_tpu_torch.ops.triage\n"
        "import foremast_tpu_torch.ops.bivariate, foremast_tpu_torch.ops.hpa\n"
        "import foremast_tpu_torch.models, foremast_tpu_torch.models.lstm_ae\n"
        "import foremast_tpu_torch.models.lstm_init, foremast_tpu_torch.engine.config\n"
        "import foremast_tpu_torch.engine, foremast_tpu_torch.engine.triage\n"
        "import foremast_tpu_torch.engine.pipeline, foremast_tpu_torch.engine.staging\n"
        "import foremast_tpu_torch.dataplane, foremast_tpu_torch.native\n"
        "import foremast_tpu_torch.resilience, foremast_tpu_torch.utils.tracing\n"
        "import foremast_tpu_torch.utils.locks, foremast_tpu_torch.utils.timeutils\n"
        "import foremast_tpu_torch.ops, foremast_tpu_torch.parallel\n"
        "import foremast_tpu_torch.parallel.mesh, foremast_tpu_torch.parallel.distributed\n"
        "new = [m for m in set(sys.modules) - before\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'foremast_tpu')]\n"
        "print(sorted(new)); sys.exit(1 if new else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_points_raise_without_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = tfl.pair_arg_spec(2, 16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfl.score_pairs(*args)
    x = np.zeros((2, 16), np.float32)
    m = np.ones((2, 16), bool)
    pol = (np.ones(2, np.float32), np.full(2, 3, np.int32), np.zeros(2, np.float32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfc.moving_average_band(x, m, ~m, 5, *pol)
    for call in (lambda: tfc.forecast_band(x, m, ~m, *pol, algorithm="holt_winters"),
                 lambda: tfc.forecast_band(x, m, ~m, *pol),
                 lambda: tfc.ses_predictions(x, m, 0.3),
                 lambda: tfc.des_predictions(x, m, 0.5, 0.1),
                 lambda: tfc.holt_winters_predictions(x, m, 4, 0.3, 0.1, 0.1),
                 lambda: tfc.detect_period(x, m, (4,), 2, 0.2),
                 lambda: tfc.fit_holt_winters(x, m, m, 4),
                 lambda: tfc.band_from_preds(x, m, ~m, x, *pol),
                 lambda: tfc.fit_seasonal_trend(x, m, m, 4),
                 lambda: tfc.forecast_band(x, m, ~m, *pol, algorithm="seasonal_trend"),
                 lambda: tfc.forecast_band(x, m, ~m, *pol, algorithm="prophet_daily"),
                 lambda: tsq.ses_predictions_assoc(x, m, 0.3),
                 lambda: tsq.des_predictions_assoc(x, m, 0.5, 0.1)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    from foremast_tpu_torch.ops import bivariate as tbv
    from foremast_tpu_torch.ops import hpa as thp
    from foremast_tpu_torch.ops import triage as ttr
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttr.screen_rows(x, m, ~m, *pol, np.zeros(2, np.float32), 5)
    row = np.ones(2, np.float32)
    mode = np.ones(2, np.int32)
    for call in (lambda: tbv.bivariate_normal_anomalies(x, m, x, m, ~m, row),
                 lambda: thp.hpa_scores(x, m, ~m, x, row, x, m, row, mode, row),
                 lambda: thp.hpa_from_preds(x, m, ~m, x, x, m, row, mode, row)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    out = tbv.bivariate_normal_anomalies(x, m, x, m, ~m, row, device="cpu")
    assert out["flags"].device.type == "cpu" and out["upper1"].shape == (2, 16)
    out = thp.hpa_from_preds(x, m, ~m, x, x, m, row, mode, row, device="cpu")
    assert out["score"].device.type == "cpu"
    from foremast_tpu_torch.models import lstm_ae as tla
    params = tla.LstmAutoencoder(hidden=8, latent=4, features=2).state_dict()
    win = np.zeros((3, 5, 2), np.float32)
    wmask = np.ones((3, 5, 2), bool)
    stack = tla.stack_params([params])
    for call in (lambda: tla.reconstruction_errors(params, win, wmask),
                 lambda: tla.fit_score_normalizer(params, win, wmask),
                 lambda: tla.anomaly_scores(params, win, wmask, 0.0, 1.0),
                 lambda: tla.anomaly_scores_fleet(stack, win[None], wmask[None], [0.0], [1.0],
                                                  hidden=8, latent=4),
                 lambda: tla.loss_and_grad(stack, win[None], wmask[None], hidden=8, latent=4),
                 lambda: tla.train(win, wmask, hidden=8, latent=4, epochs=1),
                 lambda: tla.train_fleet(win[None], wmask[None], hidden=8, latent=4, epochs=1)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert tla.reconstruction_errors(params, win, wmask, device="cpu").device.type == "cpu"
    trained, mu, sd = tla.train_fleet(win[None], wmask[None], hidden=8, latent=4, epochs=1,
                                      device="cpu")
    assert trained.device.type == mu.device.type == "cpu"
    out = tfc.forecast_band(x, m, ~m, *pol, algorithm="seasonal_trend", device="cpu")
    assert out["beta"].device.type == "cpu"
    out = tfl.score_pairs(*args, device="cpu")
    assert out["unhealthy"].device.type == "cpu"
    out = tfc.moving_average_band(x, m, ~m, 5, *pol, device="cpu")
    assert out["preds"].device.type == "cpu"
    from foremast_tpu_torch.ops import pairwise as tpw
    from foremast_tpu_torch.ops import ranks as trk
    from foremast_tpu_torch.parallel import mesh as tpm
    g3, m3 = np.zeros((2, 3, 16), np.float32), np.ones((2, 3, 16), bool)
    for call in (lambda d: tpw.all_pairwise_tests(x, m, x, m, device=d),
                 lambda d: tpw.mann_whitney_u_batch(x, m, x, m, device=d),
                 lambda d: tpw.wilcoxon_batch(x, m, x, m, device=d),
                 lambda d: tpw.ks_2samp_batch(x, m, x, m, device=d),
                 lambda d: tpw.kruskal_batch(g3, m3, device=d),
                 lambda d: tpw.friedman_batch(g3, m3[:, :, 0], device=d),
                 lambda d: trk.rank_and_ties(x, m, device=d),
                 lambda d: trk.masked_rankdata(x[0], m[0], device=d),
                 lambda d: tpw.mann_whitney_u(x[0], m[0], x[0], m[0], device=d),
                 lambda d: tpw.wilcoxon_signed_rank(x[0], m[0], x[0], m[0], device=d),
                 lambda d: tpw.ks_2samp(x[0], m[0], x[0], m[0], device=d),
                 lambda d: tpw.two_sample_tests(x[0], m[0], x[0], m[0], device=d),
                 lambda d: tpw.sign_test_exact(x[0], x[0], m[0], device=d),
                 lambda d: tpw.sign_test_batch(x, x, m, device=d),
                 lambda d: tpw.kruskal_wallis(g3[0], m3[0], device=d),
                 lambda d: tpw.friedman_chi_square(g3[0], m3[0, :, 0], device=d)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call(None)
        out = call("cpu")
        first = out[0] if isinstance(out, tuple) else (
            out if isinstance(out, torch.Tensor) else out["ks"][0])
        assert first.device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpm.fleet_mesh()


def test_tensor_on_another_device_is_an_error():
    args = list(tfl.pair_arg_spec(2, 16))
    args[0] = torch.zeros((2, 16), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="not on cpu"):
        tfl.score_pairs(*args, device="cpu")


def test_launchers_refuse_cpu_tensors():
    from foremast_tpu_torch import kernels
    x = torch.zeros((2, 16))
    m = torch.ones((2, 16), dtype=torch.bool)
    pol = (torch.ones(2), torch.full((2,), 3, dtype=torch.int32), torch.zeros(2))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.ma_band(x, m, ~m, 5, *pol)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.band_from_preds(x, m, ~m, x, *pol)
    a = torch.full((2,), 0.3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.smooth(kernels.SMOOTH_SES, x, m, a)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.affine_scan(kernels.SMOOTH_DES, x, m, a, a)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.detect_period(x, m, torch.tensor([4], dtype=torch.int32),
                              torch.full((2,), 2, dtype=torch.int32), 0.2, 0.05, 0.01)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.hw_fit(x, m, m, torch.full((2,), 4, dtype=torch.int32), torch.ones((60, 3)))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.triage_screen(x, m, ~m, 5, *pol, torch.zeros(2))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.bivariate(x, m, x, m, ~m, pol[0])
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.hpa_score(x, m, ~m, x, x, m, pol[0], pol[1], pol[0])
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.hpa_score(x, m, ~m, x, x, m, pol[0], pol[1], pol[0], tps_sigma=pol[0])
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.st_fit(x, m, m, torch.full((2,), 4, dtype=torch.int32), 3, 12, 1e-4, 3e-3, 3)
    # past 32 columns the cta path takes the row, and refuses CPU tensors
    # alike; a negative order is refused by name
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.st_fit(x, m, m, torch.full((2,), 4, dtype=torch.int32), 8, 16, 1e-4, 3e-3, 3)
    with pytest.raises(ValueError, match="order >= 0"):
        kernels.st_fit(x, m, m, torch.full((2,), 4, dtype=torch.int32), -1, 16, 1e-4, 3e-3, 3)
    P = 2 * 2 * 32 + 8 * 32 + 32 + 8 * 4 + 4 + 4 * 32 + 8 * 32 + 32 + 8 * 2 + 2
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.lstm_ae(torch.zeros((1, P)), torch.zeros((1, 3, 5, 2)),
                        torch.ones((1, 3, 5, 2), dtype=torch.bool), 8, 4)
    # any width the reference takes reaches the device check; a width of 0
    # is refused by name
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.lstm_ae(torch.zeros((1, P)), torch.zeros((1, 3, 5, 2)),
                        torch.ones((1, 3, 5, 2), dtype=torch.bool), 512, 4)
    with pytest.raises(ValueError, match=">= 1"):
        kernels.lstm_ae(torch.zeros((1, P)), torch.zeros((1, 3, 5, 2)),
                        torch.ones((1, 3, 5, 2), dtype=torch.bool), 0, 4)
    win, wmask = torch.zeros((1, 3, 5, 2)), torch.ones((1, 3, 5, 2), dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.lstm_train_forward(torch.zeros((1, P)), win, wmask, 8, 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.lstm_train_backward(torch.zeros((1, P)), win, wmask,
                                    torch.zeros((1, 3, 2, 5, 40)), 8, 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.lstm_train_forward(torch.zeros((1, P)), torch.zeros((1, 3, 5, 33)),
                                   torch.ones((1, 3, 5, 33), dtype=torch.bool), 8, 4)
    with pytest.raises(ValueError, match=">= 1"):
        kernels.lstm_train_forward(torch.zeros((1, P)), win, wmask, 8, 0)
    row = torch.zeros((1, P))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.adam(row, row, row, torch.ones(1, dtype=torch.int32), torch.zeros((1, 1, P)),
                     torch.zeros((1, 1), dtype=torch.float64),
                     torch.zeros((1, 1), dtype=torch.float64), 1e-3, 0.9, 0.999, 1e-8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.pair_tests(x, m, x, m, 15, wilcoxon_table=torch.zeros((50, 1276)),
                           ks_exact_max=256, wilcoxon_exact_max_n=50)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.rank_and_ties(x, m)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.kruskal_groups(x[None], m[None])
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.friedman(x[None], m)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.fleet_topk(x[0], 8, m[0])
    # keys past 32 bits and more rows than one launch take are served (in
    # slices, each launch keyed from 0): still CUDA tensors only
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.fleet_topk(x[0], 8, m[0], base=kernels.MAX_FLEET_ROWS)
    with pytest.raises(ValueError, match="base >= 0"):
        kernels.fleet_topk(x[0], 8, m[0], base=-1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.fleet_topk(torch.empty(kernels.MAX_FLEET_SLICE + 1, device="meta"), 8)
    # past the largest window bucket (T = 16384) kernel N's scratch path
    # serves; past its sort's int index, refused
    T = kernels.PAIR_SORT_T + 1
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.pair_tests(torch.zeros((1, 16385)), torch.ones((1, 16385), dtype=torch.bool),
                           torch.zeros((1, 16385)), torch.ones((1, 16385), dtype=torch.bool), 15,
                           wilcoxon_table=torch.zeros((50, 1276)), ks_exact_max=256,
                           wilcoxon_exact_max_n=50)
    with pytest.raises(ValueError, match=str(kernels.PAIR_SORT_T)):
        kernels.pair_tests(torch.empty((1, T), device="meta"),
                           torch.empty((1, T), dtype=torch.bool, device="meta"),
                           torch.empty((1, T), device="meta"),
                           torch.empty((1, T), dtype=torch.bool, device="meta"), 15,
                           wilcoxon_table=torch.zeros((50, 1276)), ks_exact_max=256,
                           wilcoxon_exact_max_n=50)
    assert set(kernels.launches) == {"pair_verdict", "ma_band", "band_from_preds", "smooth",
                                     "hw_fit", "affine_scan", "detect_period", "triage_screen",
                                     "bivariate", "hpa_score", "st_fit", "lstm_ae",
                                     "lstm_train_forward", "lstm_train_recurrence",
                                     "lstm_train_wgrad", "adam",
                                     "pair_tests", "rank_and_ties", "kruskal_groups", "friedman",
                                     "fleet_topk"}
    assert all(n == 0 for n in kernels.launches.values())


def test_pair_verdict_refuses_t_beyond_shared_memory():
    from foremast_tpu_torch import kernels
    # up to SHARED_PAIR_T in shared memory; above it, past the largest
    # window bucket too (a 30-day window of 43,200 steps), in device
    # scratch; past PAIR_SORT_T (its sort's int index), refused
    assert kernels.SHARED_PAIR_T == 4096
    assert [kernels.pair_path(T) for T in (4096, 4097, 16385, 43200)] == [
        "cta", "scratch", "scratch", "scratch"]
    args = [torch.from_numpy(a) for a in tfl.pair_arg_spec(1, 16385)]
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.pair_verdict(*args, wilcoxon_table=torch.zeros(1), ks_exact_max=256,
                             wilcoxon_exact_max_n=50)
    T = kernels.PAIR_SORT_T + 1
    meta = [torch.empty((1, T), dtype=a.dtype, device="meta") for a in args[:4]]
    with pytest.raises(ValueError, match=str(kernels.PAIR_SORT_T)):
        kernels.pair_verdict(*meta, *args[4:], wilcoxon_table=torch.zeros(1), ks_exact_max=256,
                             wilcoxon_exact_max_n=50)
