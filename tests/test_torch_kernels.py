"""Kernels A and B against their plain twins, on the card.

These need a CUDA device and nvcc; without them they skip. Run them on the
card with `python -m pytest tests/test_torch_kernels.py`. The comparisons
and their tolerances are chip_smoke.py's: p-values to 1e-5, booleans and
counts exact except rows bracketed at a threshold or a band edge.
"""
import numpy as np
import pytest
import torch

import chip_smoke as cs
from foremast_tpu_torch import kernels
from foremast_tpu_torch.ops import forecast as fc
from foremast_tpu_torch.parallel import fleet as fl

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    kernels.build.library()
    return torch.device("cuda")


@pytest.mark.parametrize("T", [16, 128, 1024, 4096])
def test_pair_verdict_matches_twin(card, T):
    args = cs.adversarial_pairs(512, T, np.random.default_rng(T))
    t = fl.pair_args_from_numpy(args, card)
    before = kernels.launches["pair_verdict"]
    kern = fl.score_pairs(*t)
    assert kernels.launches["pair_verdict"] == before + 1
    plain = fl.pair_verdict_plain(*t)
    torch.cuda.synchronize()
    err, _ = cs.compare_pair_verdict(t, kern, plain)
    assert err <= cs.P_ATOL


def test_pair_verdict_phase_clocks(card):
    args = cs.adversarial_pairs(256, 128, np.random.default_rng(7))
    t = fl.pair_args_from_numpy(args, card)
    clocks = torch.zeros((256, len(kernels.PAIR_PHASES) + 1), dtype=torch.int64, device=card)
    stamped = kernels.pair_verdict(
        *t, wilcoxon_table=fl.wilcoxon_pmf_table(card), ks_exact_max=fl.KS_EXACT_MAX_T,
        wilcoxon_exact_max_n=fl.WILCOXON_EXACT_MAX_N, phase_clocks=clocks)
    plain = fl.score_pairs(*t)
    torch.cuda.synchronize()
    assert bool((clocks[:, 0] > 0).all())
    assert bool((clocks.diff(dim=1) >= 0).all())
    for key in stamped:
        assert torch.equal(stamped[key], plain[key]), key


@pytest.mark.parametrize("T", [128, 1024, 16384])
def test_ma_band_matches_twin(card, T):
    gen = torch.Generator(device=card).manual_seed(T)
    args = cs.adversarial_bands(256, T, gen)
    before = kernels.launches["ma_band"]
    kern = fc.moving_average_band(*args[:3], 30, *args[3:])
    assert kernels.launches["ma_band"] == before + 1
    plain = fc.moving_average_band_plain(*args[:3], 30, *args[3:])
    torch.cuda.synchronize()
    cs.compare_ma_band(args, 30, kern, plain)
    const = torch.arange(256, device=card) % 8 == 4
    assert bool((kern["sigma"][const] == 0).all())
    assert bool((kern["count"][const] == 0).all())


def test_launchers_refuse_what_the_kernels_do_not_take(card):
    args = [torch.from_numpy(a).to(card) for a in fl.pair_arg_spec(2, kernels.MAX_PAIR_T + 1)]
    with pytest.raises(ValueError, match="4096"):
        fl.score_pairs(*args)
    x = torch.zeros((4, 64), device=card)[:, ::2]
    m = torch.ones((4, 32), dtype=torch.bool, device=card)
    pol = (torch.ones(4, device=card), torch.full((4,), 3, dtype=torch.int32, device=card),
           torch.zeros(4, device=card))
    with pytest.raises(ValueError, match="contiguous"):
        kernels.ma_band(x, m, ~m, 5, *pol)
    with pytest.raises(TypeError):
        kernels.ma_band(x.contiguous().double(), m, ~m, 5, *pol)
