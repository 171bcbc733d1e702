"""float32 triples (a, b, c) on which a fused multiply-add is easy to get
wrong, for holding K4 (csrc/fma.cu) against `ops.fma.fma_plain` on the
card (tests/test_torch_cuda.py, chip_smoke.py) and `fma` against XLA on the
CPU (tests/test_torch_fma.py), made with numpy from a seed, and the
comparison the card's checks hold K4 to.

`tie_triples`: a*b + c a hair off a float32 midpoint of c and its
neighbour, on both sides and at both parities of c, plus near-ties one ulp
of b away (the cases that a product rounded before the sum gets wrong).
`special_triples`: each operand drawn from normal values over a wide
exponent range, subnormals, tiny values whose products are subnormal,
huge values whose products overflow, signed zeros, infinities and NaN.
`compare_bits`: equal as bits, NaN as NaN, and the largest difference.
"""

from __future__ import annotations

import numpy as np
import torch


def tie_triples(n: int, seed: int = 1):
    rng = np.random.default_rng(seed)
    a, b, c = [], [], []
    for _ in range(n):
        cz = np.float32(rng.uniform(1, 2) * 2.0 ** rng.integers(-20, 40)
                        * rng.choice([-1, 1]))
        d = rng.choice([-1.0, 1.0])
        nb = np.nextafter(cz, np.float32(d * np.inf))
        m = abs(float(nb) - float(cz)) / 2  # half the spacing: a power of 2
        k = 2.0 ** -int(rng.integers(12, 24))
        if rng.random() < 0.5:
            ai, bi = np.float32(d * m * (1 + k)), np.float32(1 - k)
        else:
            ai, bi = np.float32(d * m * (1 - k)), np.float32(1 + k)
        if rng.random() < 0.25:
            bi = np.nextafter(bi, np.float32(rng.choice([-1, 1]) * np.inf))
        a.append(ai), b.append(bi), c.append(cz)
    return tuple(np.array(x, np.float32) for x in (a, b, c))


def _special(rng, n: int) -> np.ndarray:
    kind = rng.integers(0, 8, n)
    sign = rng.choice(np.float32([-1, 1]), n)
    normal = rng.uniform(1, 2, n) * 2.0 ** rng.integers(-60, 60, n)
    subnormal = rng.integers(1, 1 << 23, n).astype(np.int32).view(np.float32)
    tiny = rng.uniform(1, 2, n) * 2.0 ** rng.integers(-126, -60, n)
    huge = rng.uniform(1, 2, n) * 2.0 ** rng.integers(64, 128, n)
    pool = [normal, normal, subnormal, tiny, huge, np.zeros(n),
            np.full(n, np.inf), np.full(n, np.nan)]
    out = np.choose(kind, [np.asarray(p, np.float64) for p in pool]).astype(np.float32)
    return out * sign


def special_triples(n: int, seed: int = 2):
    rng = np.random.default_rng(seed)
    return tuple(_special(rng, n) for _ in range(3))


def compare_bits(got: torch.Tensor, want: torch.Tensor):
    """(equal, max_abs_err) of two float32 tensors: equal when the shapes
    are, and the values are as bits where `want` is not NaN (so -0.0 is not
    +0.0) and NaN where it is (a NaN's payload may differ); max_abs_err is
    the largest |got - want| over the elements finite in both."""
    if got.dtype != torch.float32 or want.dtype != torch.float32 or got.shape != want.shape:
        return False, float("inf")
    g, w = got.reshape(-1), want.reshape(-1)
    nan = torch.isnan(w)
    equal = (torch.equal(torch.isnan(g), nan)
             and torch.equal(g[~nan].view(torch.int32), w[~nan].view(torch.int32)))
    finite = torch.isfinite(g) & torch.isfinite(w)
    diff = (g[finite].double() - w[finite].double()).abs()
    return equal, float(diff.max()) if diff.numel() else 0.0
