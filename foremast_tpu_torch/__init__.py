"""PyTorch / CUDA port of foremast_tpu's scoring core, for one NVIDIA H100.

The JAX package ``foremast_tpu`` stays the reference; this package mirrors
its layout (``ops/``, ``parallel/``, ``utils/``) and imports nothing of it,
nor JAX. Ported so far: fleet canary-pair scoring
(``parallel.fleet.score_pairs``), the moving-average band family
(``ops.forecast.moving_average_band``) and the band family under the other
univariate algorithms (``ops.forecast.forecast_band``: exponential
smoothing and its long-window scan, double exponential smoothing,
Holt-Winters with period detection and its grid fit). Each runs on
hand-written CUDA kernels (``csrc/``, built at first use by ``kernels``),
each with a plain PyTorch twin that the CPU tests hold against the
reference.

Entry points run on the card unless the caller passes ``device="cpu"``;
without a card they raise rather than drift onto the CPU.
"""
