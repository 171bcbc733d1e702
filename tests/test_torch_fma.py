"""`mq3d_tpu_torch.ops.fma.fma` is the correctly rounded float32 a*b + c.

Held against XLA's fused multiply-add on the CPU (`jax.jit(lambda a, b, c:
a*b + c)`, the expression the JAX package's projection and merge compile
to) on built tie and near-tie triples, and against exact rational rounding
(`fractions.Fraction`) on random triples.  Tolerance: 0 mismatches, bit for
bit.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mq3d_tpu_torch.ops.fma import fma
from mq3d_tpu_torch.testing.fma_cases import tie_triples

torch.set_num_threads(1)

_xla_fma = jax.jit(lambda a, b, c: a * b + c)


def _port(a, b, c):
    t = [torch.from_numpy(np.asarray(x, np.float32)) for x in (a, b, c)]
    return fma(*t).numpy()


def _xla(a, b, c):
    return np.asarray(_xla_fma(*(jnp.asarray(x, jnp.float32) for x in (a, b, c))))


def _round_f32(x: Fraction) -> np.float32:
    """The float32 nearest to the rational x, ties to even."""
    f = np.float32(float(x))  # within one float32 ulp of the answer
    cands = [np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))]
    best = min(abs(Fraction(float(c)) - x) for c in cands)
    near = [c for c in cands if abs(Fraction(float(c)) - x) == best]
    if len(near) == 1:
        return near[0]
    return next(c for c in near if (c.view(np.int32) & 1) == 0)


def _exact(a, b, c):
    return np.array([_round_f32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)


def test_roadmap_case():
    a = np.float32(64 * (1 + 2.0 ** -18))
    b = np.float32(1 - 2.0 ** -18)
    c = np.float32(2.0 ** 30 + 128)
    want = _xla([a], [b], [c])
    assert want[0] == np.float32(1073741952)
    got = _port([a], [b], [c])
    np.testing.assert_array_equal(got, want)
    # The old float64-then-float32 form rounds twice and misses it.
    assert np.float32(float(a) * float(b) + float(c)) == np.float32(1073742080)


def test_ties_match_xla_and_exact():
    a, b, c = tie_triples(600)
    got = _port(a, b, c)
    xla = _xla(a, b, c)
    exact = _exact(a, b, c)
    np.testing.assert_array_equal(xla, exact)  # the oracle agrees with XLA
    assert int((got.view(np.int32) != xla.view(np.int32)).sum()) == 0
    # The set really contains double-rounding cases.
    naive = (a.astype(np.float64) * b + c).astype(np.float32)
    assert int((naive != exact).sum()) > 50


def test_random_triples_match_exact():
    rng = np.random.default_rng(0)
    n = 20_000
    scale = lambda: 2.0 ** rng.integers(-30, 30, n)  # noqa: E731
    a = (rng.standard_normal(n) * scale()).astype(np.float32)
    b = (rng.standard_normal(n) * scale()).astype(np.float32)
    c = (rng.standard_normal(n) * scale()).astype(np.float32)
    got = _port(a, b, c)
    exact = _exact(a, b, c)
    assert int((got.view(np.int32) != exact.view(np.int32)).sum()) == 0
    np.testing.assert_array_equal(got, _xla(a, b, c))


def test_special_values():
    inf = np.float32(np.inf)
    a = np.array([0, -0.0, inf, 1, 3e38, 1, np.nan], np.float32)
    b = np.array([5, 1, 1, -inf, 10, 0, 1], np.float32)
    c = np.array([-0.0, -0.0, 1, 1, 0, np.nan, 1], np.float32)
    got = _port(a, b, c)
    want = _xla(a, b, c)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    m = ~np.isnan(want)
    np.testing.assert_array_equal(got[m].view(np.int32), want[m].view(np.int32))
