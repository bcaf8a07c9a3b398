"""The LSTM autoencoder's initial parameters, as the reference draws them.

Every job of the reference's engine starts its training from
``init_state(model, PRNGKey(0), T=W)`` (reference ``models/lstm_ae.py:131``),
and the parameters training starts from decide the trained model, so the
port starts from the same ones. They are drawn here with numpy alone:

  * JAX's threefry2x32 (the counter-based hash of ``jax._src.prng``), its
    key derivation under ``jax_threefry_partitionable=True`` (a key's bits
    are the hash of the flat element index, the two words xor-ed), and
    ``fold_in`` (the hash of the counter pair (0, data));
  * flax's per-parameter key: ``make_rng("params")`` in the scope of a
    parameter folds the SHA-1 of the scope's path and a per-scope counter
    into the root key (``flax/core/scope.py`` ``_fold_in_static``); a
    Dense's kernel is its scope's first draw;
  * ``lecun_normal`` (a normal truncated to (-2, 2), scaled to variance
    1 / fan_in) for the input kernels and both Dense kernels, ``orthogonal``
    (the Q of a normal draw's QR, its columns signed by diag(R)) for the
    four recurrent kernels of each cell, zeros for every bias.

The uniform draw, XLA's float32 ``erf_inv`` (Giles' polynomials) and the
``log1p`` and ``log`` it rests on are written out as XLA's CPU backend
compiles them, fused multiply-adds included (a float64 product and sum
rounded once to float32; a double rounding can in principle differ from a
true fused rounding, in about one case in 2^29). So the truncated and plain
normal draws equal ``jax.random``'s bit for bit. The QR cannot: LAPACK's
float32 Householder sums in an order of its BLAS. It is taken here in
float64 and rounded, within a few float32 ulps of the reference's
(tests/test_torch_lstm_train.py states the tolerance).
"""
from __future__ import annotations

import hashlib
import math
import struct

import numpy as np
import torch

__all__ = ["threefry2x32", "fold_in", "fold_in_static", "random_bits", "erf_inv",
           "truncated_normal", "normal", "lecun_normal", "orthogonal", "init_tree",
           "init_params"]

_F32, _F64, _U32 = np.float32, np.float64, np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(key, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter pairs (x0, x1) under key
    (k0, k1): JAX's ``threefry2x32_p``. Returns two uint32 arrays."""
    k0, k1 = _U32(key[0]), _U32(key[1])
    ks = (k0, k1, _U32(k0 ^ k1 ^ _U32(0x1BD11BDA)))
    x0 = np.asarray(x0, _U32) + ks[0]
    x1 = np.asarray(x1, _U32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = (x1 << _U32(r)) | (x1 >> _U32(32 - r))
            x1 = x0 ^ x1
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3]
        x1 = x1 + _U32(i + 1)
    return x0, x1


def fold_in(key, data: int) -> tuple:
    """``jax.random.fold_in(key, data)``: the hash of (0, data) under key."""
    a, b = threefry2x32(key, [0], [data])
    return (int(a[0]), int(b[0]))


def fold_in_static(key, path) -> tuple:
    """flax's ``_fold_in_static``: the first four bytes of the SHA-1 of the
    path's strings (UTF-8) and ints (big-endian, minimal length), folded in."""
    h = hashlib.sha1()
    for p in path:
        h.update(p.encode() if isinstance(p, str)
                 else p.to_bytes((p.bit_length() + 7) // 8, "big"))
    return fold_in(key, int.from_bytes(h.digest()[:4], "big"))


def random_bits(key, n: int) -> np.ndarray:
    """n uint32 random words under key (partitionable threefry: the hash of
    the flat index i as the pair (i >> 32, i & 0xffffffff), words xor-ed)."""
    idx = np.arange(n, dtype=np.uint64)
    a, b = threefry2x32(key, (idx >> np.uint64(32)).astype(_U32), idx.astype(_U32))
    return a ^ b


def _fma(a, b, c):
    """a b + c rounded once to float32 (the product of two float32 values is
    exact in float64)."""
    return (np.asarray(a, _F64) * np.asarray(b, _F64) + np.asarray(c, _F64)).astype(_F32)


def _hexf(h: str):
    return _F32(struct.unpack(">d", bytes.fromhex(h))[0])


# XLA's float32 log (Cephes' logf): mantissa polynomial coefficients, in
# the order the compiled program uses them, and ln 2 split in two
_LOG_C = tuple(_hexf(h) for h in (
    "3FB2043760000000", "BFBD7A3700000000", "3FBDE4A340000000", "BFBFCBA9E0000000",
    "3FC23D37E0000000", "BFC555CA00000000", "3FC999D580000000", "BFCFFFFF80000000",
    "3FD5555540000000"))
_LN2_LO, _LN2_HI = _hexf("BF2BD01060000000"), _hexf("3FE6300000000000")
_FLT_MIN, _SQRT_HALF = _hexf("3810000000000000"), _hexf("3FE6A09E60000000")
# XLA's log1p below sqrt(2) - 1: Cephes' rational approximation
_LOG1P_DEN = (1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)
_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553073277375E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG1P_SMALL = _hexf("3FDA8279A0000000")
# XLA's float32 erf_inv (Giles): coefficients for w < 5 and for w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _log(v):
    """XLA's float32 log of v > 0 (0 gives -inf, inf gives inf)."""
    v = np.asarray(v, _F32)
    x = np.where(v > _FLT_MIN, v, _FLT_MIN).astype(_F32)
    bits = x.view(_U32)
    m = ((bits & _U32(0x7FFFFF)) | _U32(0x3F000000)).view(_F32)
    e = ((bits >> _U32(23)).astype(np.int32) - 127).astype(_F32) + _F32(1)
    low = m < _SQRT_HALF
    e = (e - np.where(low, _F32(1), _F32(0))).astype(_F32)
    xx = ((m + _F32(-1)) + np.where(low, m, _F32(0))).astype(_F32)
    z = xx * xx
    z3 = z * xx
    c = _LOG_C
    y1 = _fma(_fma(xx, c[0], c[1]), xx, c[2])
    y2 = _fma(_fma(xx, c[3], c[4]), xx, c[5])
    y3 = _fma(_fma(xx, c[6], c[7]), xx, c[8])
    y = _fma(_fma(_fma(y1, z3, y2), z3, y3), z3, e * _LN2_LO)
    r = _fma(e, _LN2_HI, _fma(-z, _F32(0.5), xx) + y)
    r = np.where(v == 0, _F32(-np.inf), r)
    return np.where(v == np.inf, _F32(np.inf), r).astype(_F32)


def _log1p(v):
    """XLA's float32 log1p of v > -1."""
    v = np.asarray(v, _F32)
    den = np.ones_like(v)
    for c in _LOG1P_DEN:
        den = _fma(den, v, _F32(c))
    num = np.full_like(v, _F32(_LOG1P_NUM[0]))
    for c in _LOG1P_NUM[1:]:
        num = _fma(num, v, _F32(c))
    v2 = v * v
    small = v + _fma(v2, _F32(-0.5), (v * v2) * (num / den))
    return np.where(np.abs(v) < _LOG1P_SMALL, small, _log(v + _F32(1))).astype(_F32)


def erf_inv(x):
    """XLA's float32 erf_inv of x in [-1, 1]."""
    x = np.asarray(x, _F32)
    w = -_log1p(x * -x)
    lt = w < _F32(5)
    w = np.where(lt, w - _F32(2.5), np.sqrt(w) - _F32(3)).astype(_F32)
    p = np.where(lt, _F32(_ERFINV_LT5[0]), _F32(_ERFINV_GE5[0])).astype(_F32)
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, w, np.where(lt, _F32(a), _F32(b)))
    return np.where(np.abs(x) == 1, np.copysign(_F32(np.inf), x), p * x).astype(_F32)


def _uniform(key, n: int, lo, hi):
    """``jax.random.uniform`` in [lo, hi): 23 random mantissa bits a value."""
    fb = (random_bits(key, n) >> _U32(9)) | np.array(1.0, _F32).view(_U32)
    floats = fb.view(_F32) - _F32(1)
    lo, hi = _F32(lo), _F32(hi)
    return np.maximum(lo, _fma(floats, hi - lo, lo))


_SQRT2 = _F32(math.sqrt(2))


def truncated_normal(key, shape, lower: float = -2.0, upper: float = 2.0):
    """``jax.random.truncated_normal`` (float32): sqrt(2) erf_inv of a uniform
    draw between erf(lower / sqrt 2) and erf(upper / sqrt 2), clipped to
    the open interval."""
    lo, hi = _F32(lower), _F32(upper)
    a = _F32(math.erf(float(lo / _SQRT2)))
    b = _F32(math.erf(float(hi / _SQRT2)))
    out = _SQRT2 * erf_inv(_uniform(key, math.prod(shape), a, b))
    return np.clip(out, np.nextafter(lo, _F32(np.inf)),
                   np.nextafter(hi, _F32(-np.inf))).astype(_F32).reshape(shape)


def normal(key, shape):
    """``jax.random.normal`` (float32): sqrt(2) erf_inv of a uniform draw in
    (-1, 1)."""
    u = _uniform(key, math.prod(shape), np.nextafter(_F32(-1), _F32(0)), 1.0)
    return (_SQRT2 * erf_inv(u)).astype(_F32).reshape(shape)


def lecun_normal(key, shape):
    """``jax.nn.initializers.lecun_normal()`` of a (fan_in, fan_out) kernel."""
    std = np.sqrt(_F32(1.0 / shape[0])) / _F32(0.87962566103423978)
    return (truncated_normal(key, shape) * std).astype(_F32)


def orthogonal(key, n: int):
    """``jax.nn.initializers.orthogonal()`` of an (n, n) kernel: Q of the QR
    of a normal draw, each column times the sign of R's diagonal entry
    (the QR in float64, rounded)."""
    q, r = np.linalg.qr(normal(key, (n, n)).astype(_F64))
    return (q * np.sign(np.diag(r))[None, :]).astype(_F32)


def init_tree(features: int, hidden: int, latent: int, seed: int = 0) -> dict:
    """The reference's ``init_state(LstmAutoencoder(hidden, latent,
    features), PRNGKey(seed), T)["params"]`` as nested dicts of numpy
    arrays (flax's tree; no entry depends on T)."""
    F, H, Z = int(features), int(hidden), int(latent)
    root = (int(seed) >> 32 & 0xFFFFFFFF, int(seed) & 0xFFFFFFFF)
    tree = {}
    for cell, n_in in (("LSTMCell_0", 2 * F), ("LSTMCell_1", Z)):
        t = {}
        for g in "ifgo":
            t["i" + g] = {"kernel": lecun_normal(fold_in_static(root, (cell, "i" + g, 1)),
                                                 (n_in, H))}
            t["h" + g] = {"kernel": orthogonal(fold_in_static(root, (cell, "h" + g, 1)), H),
                          "bias": np.zeros(H, _F32)}
        tree[cell] = t
    for dense, n_in, n_out in (("Dense_0", H, Z), ("Dense_1", H, F)):
        tree[dense] = {"kernel": lecun_normal(fold_in_static(root, (dense, 1)), (n_in, n_out)),
                       "bias": np.zeros(n_out, _F32)}
    return tree


def init_params(features: int, hidden: int, latent: int, seed: int = 0) -> torch.Tensor:
    """The reference's initial parameters at PRNGKey(seed) as one flat (P,)
    float32 CPU row in models.lstm_ae's layout."""
    from .lstm_ae import flat_params, params_from_flax

    return flat_params(params_from_flax(init_tree(features, hidden, latent, seed)))
