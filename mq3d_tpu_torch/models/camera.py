"""Small typed camera metadata structures.

(reference: scripts/models/camera_characteristics.py:6,
 scripts/models/image_format_info.py:5-26,
 scripts/models/confidence_map.py:7)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass
class CameraCharacteristics:
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float
    transl: np.ndarray  # head-from-camera translation
    rot_quat: np.ndarray  # head-from-camera rotation, xyzw


@dataclass
class ImagePlaneInfo:
    buffer_size: int
    row_stride: int
    pixel_stride: int


@dataclass
class BaseTime:
    mono_time_ns: int
    unix_time_ns: int


@dataclass
class ImageFormatInfo:
    width: int
    height: int
    format: str
    planes: List[ImagePlaneInfo]
    base_time: BaseTime


@dataclass
class ConfidenceMap:
    """Per-pixel multi-view consistency ratio + supporting-view count."""

    confidence_map: np.ndarray
    valid_count: np.ndarray

    def __post_init__(self):
        if self.confidence_map.shape != self.valid_count.shape:
            raise ValueError("confidence_map and valid_count shapes differ")
        if self.confidence_map.ndim != 2:
            raise ValueError("confidence_map must be 2D")

    @property
    def height(self) -> int:
        return self.confidence_map.shape[0]

    @property
    def width(self) -> int:
        return self.confidence_map.shape[1]

    @property
    def shape(self):
        return self.confidence_map.shape
