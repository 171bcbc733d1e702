"""YUV420_888 -> BGR conversion and image-quality filters on tensors.

Counterpart of mq3d_tpu/ops/yuv.py.  Planes are de-strided on the host with
numpy (memory reshuffling, not compute); the colour conversion is one
batched integer pass over a stack of frames, bit-exact with OpenCV's
fixed-point BT.601 path:

  `yuv420_to_bgr`   dispatches: K2, the hand-written CUDA kernel
                    (csrc/i420.cu), for tensors on the card; the plain
                    version for tensors on the CPU.
  `yuv420_to_8uc3`  the plain PyTorch version (same function as the JAX
                    build's `yuv420_to_8uc3` and its Pallas kernel).

OpenCV's ITU-R BT.601 fixed-point constants (20-bit shift):
  CY=1220542  CUB=2116026  CUG=-409993  CVG=-852492  CVR=1673527
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from mq3d_tpu_torch.device import resolve_device
from mq3d_tpu_torch.kernels import _build
from mq3d_tpu_torch.models.camera import ImageFormatInfo

_SHIFT = 20
_CY = 1220542
_CUB = 2116026
_CUG = -409993
_CVG = -852492
_CVR = 1673527


# ---------------------------------------------------------------------------
# Host-side plane de-striding (memory reshuffling, not compute)
# ---------------------------------------------------------------------------

def destride_plane(data: np.ndarray, offset: int, width: int, height: int,
                   row_stride: int, pixel_stride: int) -> np.ndarray:
    """Extract a (height, width) plane from a strided Android image buffer
    (a single strided view + copy instead of a Python row loop)."""
    needed = offset + (height - 1) * row_stride + width * pixel_stride
    flat = np.frombuffer(data, dtype=np.uint8, count=min(needed, len(data)))
    # Pad if the final row is short of a full stride (legal in the format).
    if len(flat) < needed:
        flat = np.concatenate([flat, np.zeros(needed - len(flat), np.uint8)])
    rows = np.lib.stride_tricks.as_strided(
        flat[offset:], shape=(height, width), strides=(row_stride, pixel_stride)
    )
    return np.ascontiguousarray(rows)


def split_yuv420_planes(
    raw_data, format_info: ImageFormatInfo, uv_order: str = "NV12"
) -> tuple:
    """Raw YUV420_888 buffer -> (Y, U, V) uint8 planes.

    Handles planar (pixel_stride 1) and semi-planar NV12/NV21 (pixel_stride 2)
    chroma layouts (reference image_utils.py:19-57).
    """
    w, h = format_info.width, format_info.height
    planes = format_info.planes
    if len(planes) != 3:
        raise ValueError("Expected 3 planes for YUV420_888 format")

    y = destride_plane(raw_data, 0, w, h, planes[0].row_stride, planes[0].pixel_stride)
    u_offset = planes[0].buffer_size
    cw, ch = w // 2, h // 2
    ps_uv = planes[1].pixel_stride
    rs_uv = planes[1].row_stride

    if ps_uv == 1:
        u = destride_plane(raw_data, u_offset, cw, ch, rs_uv, 1)
        v_offset = u_offset + planes[1].buffer_size
        v = destride_plane(raw_data, v_offset, cw, ch, planes[2].row_stride, 1)
    else:
        first = destride_plane(raw_data, u_offset, cw, ch, rs_uv, ps_uv)
        second = destride_plane(raw_data, u_offset + 1, cw, ch, rs_uv, ps_uv)
        if uv_order == "NV21":
            v, u = first, second
        else:
            u, v = first, second
    return y, u, v


def assemble_i420(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Planes -> packed I420 buffer of shape (H*3//2, W), as cv2 expects."""
    h, w = y.shape
    return np.concatenate([y.ravel(), u.ravel(), v.ravel()]).reshape(h * 3 // 2, w)


# ---------------------------------------------------------------------------
# Batched colour conversion (bit-exact with OpenCV BT.601)
# ---------------------------------------------------------------------------

def yuv420_to_8uc3(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                   order: str = "bgr") -> torch.Tensor:
    """Plain version: (N, H, W) luma + (N, H/2, W/2) chroma uint8 ->
    (N, H, W, 3) uint8, replicating OpenCV's fixed-point integer path."""
    y = y.to(torch.int32)
    u_full = u.to(torch.int32).repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
    v_full = v.to(torch.int32).repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)

    uu = u_full - 128
    vv = v_full - 128
    half = 1 << (_SHIFT - 1)
    ruv = half + _CVR * vv
    guv = half + _CVG * vv + _CUG * uu
    buv = half + _CUB * uu

    y00 = torch.clamp(y - 16, min=0) * _CY
    r = torch.clamp((y00 + ruv) >> _SHIFT, 0, 255).to(torch.uint8)
    g = torch.clamp((y00 + guv) >> _SHIFT, 0, 255).to(torch.uint8)
    b = torch.clamp((y00 + buv) >> _SHIFT, 0, 255).to(torch.uint8)
    channels = (b, g, r) if order == "bgr" else (r, g, b)
    return torch.stack(channels, dim=-1)


def _check_planes(y, u, v):
    if not (y.dtype == u.dtype == v.dtype == torch.uint8):
        raise TypeError(f"I420 planes must be uint8, got {y.dtype}, {u.dtype}, {v.dtype}")
    if y.ndim != 3 or u.ndim != 3 or v.ndim != 3:
        raise ValueError("I420 planes must be (N, H, W) and (N, H/2, W/2)")
    n, h, w = y.shape
    if h % 2 or w % 2 or tuple(u.shape) != (n, h // 2, w // 2) or u.shape != v.shape:
        raise ValueError(
            f"I420 needs even H, W and chroma (N, H/2, W/2): got "
            f"{tuple(y.shape)}, {tuple(u.shape)}, {tuple(v.shape)}")
    if not (y.device == u.device == v.device):
        raise ValueError("I420 planes must lie on one device")


def yuv420_to_bgr(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(N, H, W) + 2x (N, H/2, W/2) uint8 -> (N, H, W, 3) BGR uint8.

    CUDA tensors launch K2; CPU tensors take the plain version."""
    _check_planes(y, u, v)
    if y.device.type == "cpu":
        return yuv420_to_8uc3(y, u, v, order="bgr")
    if y.device.type != "cuda":
        raise ValueError(f"yuv420_to_bgr: unsupported device {y.device}")
    n, h, w = y.shape
    if n * h * w * 3 >= 2 ** 62:
        raise ValueError("yuv420_to_bgr: batch too large")
    y, u, v = y.contiguous(), u.contiguous(), v.contiguous()
    out = torch.empty((n, h, w, 3), dtype=torch.uint8, device=y.device)
    if out.numel() == 0:  # nothing to launch
        return out
    _build.launch("i420_to_bgr", y.device, y.data_ptr(), u.data_ptr(), v.data_ptr(),
                  out.data_ptr(), n, h, w)
    return out


def convert_yuv420_888_to_bgr(
    raw_data, format_info: ImageFormatInfo, uv_order: str = "NV12", device="cuda",
) -> np.ndarray:
    """One frame, the reference's single-frame API (reference
    image_utils.py:60-71): de-stride on the host, convert on `device` (K2
    with N=1 on the card).  Returns (H, W, 3) BGR uint8 on the host."""
    return convert_yuv_batch([raw_data], format_info, uv_order, device)[0]


def convert_yuv_batch(
    raw_buffers: list, format_info: ImageFormatInfo, uv_order: str = "NV12",
    device="cuda",
) -> np.ndarray:
    """De-stride on the host, convert the whole stack in one launch on
    `device`.  Returns (N, H, W, 3) BGR uint8 on the host."""
    dev = resolve_device(device)
    planes = [split_yuv420_planes(raw, format_info, uv_order) for raw in raw_buffers]
    ys, us, vs = (torch.from_numpy(np.stack(p)).to(dev) for p in zip(*planes))
    return yuv420_to_bgr(ys, us, vs).cpu().numpy()


# ---------------------------------------------------------------------------
# Image-quality filters (blur / exposure), batched, plain PyTorch
# ---------------------------------------------------------------------------

# Gray weights as the JAX build evaluates them: XLA's CPU backend contracts
# 0.299 R + 0.587 G + 0.114 B into rint(fma(0.114, B, fma(0.299, R, 0.587 G)))
# in float64.  The port computes that chain exactly in int64 fixed point
# (units of 2^-56, the finest ulp of the three constants), so the CPU and
# the card give the same bytes whatever FMA contraction their compilers do.
_GRAY_FRAC_BITS = 56
_GRAY_ONE = 1 << _GRAY_FRAC_BITS


def _fixed_product(c: float, x: torch.Tensor):
    """Exact c * x for an int64 tensor x in [0, 255], as (integer part,
    fraction in units of 2^-56).  c's numerator has 53 bits, so the product
    fits int64."""
    num, den = c.as_integer_ratio()
    shift = den.bit_length() - 1
    prod = x * num
    return prod >> shift, (prod & (den - 1)) << (_GRAY_FRAC_BITS - shift)


def _fixed_add(a, b):
    f = a[1] + b[1]
    return a[0] + b[0] + (f >> _GRAY_FRAC_BITS), f & (_GRAY_ONE - 1)


def _round_to_double(q: torch.Tensor, f: torch.Tensor):
    """Round q + f / 2^56 (0 <= value < 512) to the nearest float64, ties to
    even, keeping the fixed-point form."""
    # The float64 ulp at this value is 2^s units: s = floor(log2 q) + 4 for
    # values >= 1, and for values < 1 the bits of f beyond 53.
    e_q = sum((q >= (1 << j)).long() for j in range(1, 9))
    e_f = sum((f >= (1 << j)).long() for j in range(53, 56))
    s = torch.where(q > 0, e_q + 4, e_f)
    unit = torch.ones_like(f) << s
    rem = f & (unit - 1)
    half = unit >> 1
    down = f - rem
    odd = ((down >> s) & 1) == 1
    up = (rem > half) | ((rem == half) & (half > 0) & odd)
    f = down + (up.long() << s)
    return q + (f >> _GRAY_FRAC_BITS), f & (_GRAY_ONE - 1)


def bgr_to_gray(bgr: torch.Tensor) -> torch.Tensor:
    """BGR uint8 -> gray uint8, equal to the JAX build's `bgr_to_gray` on
    every input: rint(fma(0.114, B, fma(0.299, R, 0.587 G))) with float64
    FMAs (each rounded once) and round-half-to-even, computed exactly in
    int64 fixed point."""
    x = bgr.to(torch.int64)
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    acc = _round_to_double(*_fixed_product(0.587, g))
    acc = _round_to_double(*_fixed_add(_fixed_product(0.299, r), acc))
    q, f = _round_to_double(*_fixed_add(_fixed_product(0.114, b), acc))
    half = _GRAY_ONE >> 1
    up = (f > half) | ((f == half) & ((q & 1) == 1))
    return (q + up.long()).to(torch.uint8)


def laplacian_variance(gray: torch.Tensor) -> torch.Tensor:
    """Blur metric: variance of the 3x3 Laplacian with reflect-101 borders,
    matching cv2.Laplacian(img, CV_64F).var().  gray: (..., H, W) uint8."""
    x = gray.to(torch.float32)
    lead = x.shape[:-2]
    p = F.pad(x.reshape(-1, 1, *x.shape[-2:]), (1, 1, 1, 1), mode="reflect")
    p = p.reshape(*lead, x.shape[-2] + 2, x.shape[-1] + 2)
    lap = (p[..., :-2, 1:-1] + p[..., 2:, 1:-1] + p[..., 1:-1, :-2]
           + p[..., 1:-1, 2:] - 4.0 * x)
    mean = lap.mean(dim=(-2, -1), keepdim=True)
    return ((lap - mean) ** 2).mean(dim=(-2, -1))


def exposure_cdf(gray: torch.Tensor) -> torch.Tensor:
    """Normalized histogram CDF over 256 bins: (..., H, W) uint8 ->
    (..., 256) float32."""
    flat = gray.reshape(-1) if gray.ndim == 2 else gray.reshape(gray.shape[0], -1)
    rows = flat.reshape(1, -1) if flat.ndim == 1 else flat
    hist = torch.stack([torch.bincount(r.long(), minlength=256) for r in rows])
    hist = hist.to(torch.float32)
    cdf = torch.cumsum(hist / hist.sum(dim=-1, keepdim=True), dim=-1)
    return cdf[0] if flat.ndim == 1 else cdf


def is_over_or_under_exposed(gray: torch.Tensor, low_thresh=0.02,
                             high_thresh=0.02) -> np.ndarray:
    """cum[5] > low or cum[250] < high (reference image_utils.py:78-83)."""
    cdf = exposure_cdf(gray).cpu().numpy()
    return (cdf[..., 5] > low_thresh) | (cdf[..., 250] < high_thresh)


def is_blur_image(bgr: torch.Tensor, blur_threshold: float = 50.0) -> np.ndarray:
    return laplacian_variance(bgr_to_gray(bgr)).cpu().numpy() < blur_threshold
