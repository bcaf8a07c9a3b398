"""The port's numerics: plain-torch twins and the entry points onto the
kernels. The same names as the reference's ``ops`` package; importing it
builds nothing (the kernel library builds at its first launch)."""
from .ranks import masked_rankdata, rank_and_ties  # noqa: F401
from .pairwise import (  # noqa: F401
    all_pairwise_tests,
    friedman_chi_square,
    kruskal_wallis,
    ks_2samp,
    mann_whitney_u,
    sign_test_exact,
    two_sample_tests,
    wilcoxon_signed_rank,
)
from .stats import chi2_sf, kolmogorov_sf, norm_sf  # noqa: F401
from .bivariate import bivariate_normal_anomalies  # noqa: F401
