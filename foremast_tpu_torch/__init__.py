"""PyTorch / CUDA port of foremast_tpu, for one NVIDIA H100.

The JAX package ``foremast_tpu`` stays the reference; this package mirrors
its layout (``engine/``, ``dataplane/``, ``ops/``, ``parallel/``,
``resilience/``, ``utils/``, ``native/``) and imports nothing of it, nor
JAX. Ported so far: the engine cycle (``engine.Analyzer.run_cycle``:
claim, fetch and parse, pack into pinned buffers, the tier-0 triage screen
``ops.triage.screen_rows``, the pair and band families, fold), fleet
canary-pair scoring (``parallel.fleet.score_pairs``), the moving-average
band family (``ops.forecast.moving_average_band``) and the band family under
the other univariate algorithms (``ops.forecast.forecast_band``: exponential
smoothing and its long-window scan, double exponential smoothing,
Holt-Winters with period detection and its grid fit, seasonal-trend), the
bivariate, HPA and LSTM-autoencoder families, the public test battery
(``ops``: ``all_pairwise_tests``, the ``*_batch`` tests, ``rank_and_ties``)
and the multi-GPU fleet scorer on torch.distributed
(``parallel.make_fleet_scorer``, ``fleet_summary``). Each runs on
hand-written CUDA kernels (``csrc/``, built at first use by ``kernels``),
each with a plain PyTorch twin that the CPU tests hold against the
reference.

Entry points run on the card unless the caller passes ``device="cpu"``;
without a card they raise rather than drift onto the CPU.
"""
