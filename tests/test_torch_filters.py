"""The port's blur and exposure filters against the JAX package's.

`bgr_to_gray` is held exactly over all 2^24 BGR triples: XLA evaluates it
as rint(fma(0.114, B, fma(0.299, R, 0.587 G))) in float64, and the port
repeats that chain in exact fixed point.  The float32 filters sum in
another order than XLA, so they get tolerances derived below; the
decisions built on them (`is_blur_image`, `is_over_or_under_exposed`) are
held exactly on seeded images away from their thresholds.
"""

import numpy as np
import pytest
import torch

from mq3d_tpu.ops import yuv as jax_yuv
from mq3d_tpu_torch.ops import yuv as torch_yuv

torch.set_num_threads(1)

CHUNK = 1 << 20  # 2^24 triples in 16 chunks keeps memory low per worker


def _triples(chunk: int) -> np.ndarray:
    idx = np.arange(chunk * CHUNK, (chunk + 1) * CHUNK, dtype=np.int64)
    return np.stack([idx & 255, (idx >> 8) & 255, idx >> 16], -1).astype(np.uint8)


@pytest.mark.parametrize("half", [0, 1])
def test_bgr_to_gray_matches_jax_on_every_triple(half):
    """Exact on all 2^24 (B, G, R) triples, in two halves of 8 chunks."""
    mismatches = 0
    for chunk in range(8 * half, 8 * half + 8):
        bgr = _triples(chunk)
        want = np.asarray(jax_yuv.bgr_to_gray(bgr))
        got = torch_yuv.bgr_to_gray(torch.from_numpy(bgr)).numpy()
        mismatches += int((want != got).sum())
    assert mismatches == 0


@pytest.mark.parametrize("bgr,gray", [
    ((0, 20, 240), 84),   # XLA's contraction rounds these where a plain
    ((0, 110, 70), 85),   # float64 sum a*b + c*d + e*f would not
    ((255, 255, 255), 255),
    ((0, 0, 0), 0),
])
def test_bgr_to_gray_known_values(bgr, gray):
    x = torch.tensor([bgr], dtype=torch.uint8)
    assert int(torch_yuv.bgr_to_gray(x)[0]) == gray
    assert int(np.asarray(jax_yuv.bgr_to_gray(x.numpy()))[0]) == gray


def _images(rng, shape):
    """Noise (sharp), a smooth ramp (blurry) and dark and bright frames."""
    h, w = shape
    noise = rng.integers(0, 256, (h, w), dtype=np.uint8)
    ramp = np.add.outer(np.arange(h), np.arange(w)).astype(np.float64)
    ramp = (ramp / ramp.max() * 200 + 20).astype(np.uint8)
    dark = rng.integers(0, 4, (h, w), dtype=np.uint8)
    bright = rng.integers(252, 256, (h, w), dtype=np.uint8)
    return np.stack([noise, ramp, dark, bright])


@pytest.mark.parametrize("shape", [(48, 64), (37, 53)])
def test_laplacian_variance_matches_jax(rng, shape):
    """Both sum H*W float32 terms twice (mean, then variance) in different
    orders; blocked or pairwise sums of n terms err by ~log2(n) * 2^-24
    each, well under the stated rtol of 1e-5 (measured: < 3e-7)."""
    gray = _images(rng, shape)
    want = np.asarray(jax_yuv.laplacian_variance(gray))
    got = torch_yuv.laplacian_variance(torch.from_numpy(gray)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    got2d = torch_yuv.laplacian_variance(torch.from_numpy(gray[0])).numpy()
    np.testing.assert_allclose(got2d, want[0], rtol=1e-5, atol=0)


@pytest.mark.parametrize("shape", [(48, 64), (37, 53)])
def test_exposure_cdf_matches_jax(rng, shape):
    """Histograms are exact counts; the cumulative sum of 256 float32
    terms in [0, 1] rounds each of its 255 additions by at most 2^-24, in
    each version, so the two differ by at most 2 * 255 * 2^-24 < 3.1e-5."""
    gray = _images(rng, shape)
    want = np.asarray(jax_yuv.exposure_cdf(gray))
    got = torch_yuv.exposure_cdf(torch.from_numpy(gray)).numpy()
    assert got.shape == want.shape == (4, 256)
    np.testing.assert_allclose(got, want, rtol=0, atol=3.1e-5)
    got1 = torch_yuv.exposure_cdf(torch.from_numpy(gray[1])).numpy()
    np.testing.assert_allclose(got1, want[1], rtol=0, atol=3.1e-5)


def test_filter_decisions_match_jax(rng):
    """The boolean filters agree exactly, and each takes both values."""
    gray = _images(rng, (48, 64))
    bgr = np.repeat(gray[..., None], 3, axis=-1)
    bgr[0] = rng.integers(0, 256, bgr[0].shape, dtype=np.uint8)  # colour noise
    want_blur = jax_yuv.is_blur_image(bgr)
    got_blur = torch_yuv.is_blur_image(torch.from_numpy(bgr))
    np.testing.assert_array_equal(got_blur, want_blur)
    assert want_blur.any() and not want_blur.all()
    want_exp = jax_yuv.is_over_or_under_exposed(gray)
    got_exp = torch_yuv.is_over_or_under_exposed(torch.from_numpy(gray))
    np.testing.assert_array_equal(got_exp, want_exp)
    assert want_exp.any() and not want_exp.all()
