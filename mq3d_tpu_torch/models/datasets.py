"""Frame-table datasets: structure-of-arrays camera/depth frame tables.

Re-design of the reference's CameraDataset/DepthDataset (reference:
scripts/models/camera_dataset.py:13-214) with identical npz serialization
(keys: directory_relative_path, image_file_names, timestamps, fx, fy, cx, cy,
coordinate_system, positions, rotations, widths, heights [, nears, fars]) so
caches are interchangeable with the reference.

These tables are the host-side staging structure: columns are numpy arrays
that stream to the card as stacked per-frame tensors (see ops/ and recon/).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, List, Type, TypeVar, Union

import numpy as np

from mq3d_tpu_torch.geometry.intrinsics import intrinsic_matrices, mirror_cx
from mq3d_tpu_torch.models.transforms import CoordinateSystem, Transforms

T = TypeVar("T", bound="CameraDataset")


@dataclass
class CameraDataset:
    directory_relative_path: str
    image_file_names: np.ndarray
    timestamps: np.ndarray
    fx: np.ndarray
    fy: np.ndarray
    cx: np.ndarray
    cy: np.ndarray
    transforms: Transforms
    widths: np.ndarray
    heights: np.ndarray

    def __post_init__(self):
        n = self.timestamps.shape[0]
        for key, v in self.to_dict().items():
            if isinstance(v, np.ndarray) and v.ndim > 0:
                assert v.shape[0] == n, f"column {key} length {v.shape[0]} != {n}"

    # -- indexing -------------------------------------------------------------

    def __len__(self) -> int:
        return int(self.timestamps.shape[0])

    def __getitem__(self: T, idx) -> Union[dict, T]:
        data = self.to_dict()
        if isinstance(idx, (int, np.integer)):
            return {
                k: (v[idx] if isinstance(v, np.ndarray) and v.ndim > 0 else v)
                for k, v in data.items()
            }
        if isinstance(idx, (slice, list, np.ndarray)):
            subset = {
                k: (v[idx] if isinstance(v, np.ndarray) and v.ndim > 0 else v)
                for k, v in data.items()
            }
            return self.__class__.from_dict(subset)
        raise TypeError(f"Unsupported index type: {type(idx)}")

    def __iter__(self) -> Iterator[dict]:
        for i in range(len(self)):
            yield self[i]

    def find_nearest_index(self, timestamp: int) -> int:
        """Nearest frame by timestamp (assumes sorted timestamps;
        reference camera_dataset.py:81-90)."""
        ts = self.timestamps
        i = int(np.searchsorted(ts, timestamp, side="left"))
        if i == len(ts):
            return i - 1
        if i == 0:
            return 0
        return i if abs(ts[i] - timestamp) < abs(ts[i - 1] - timestamp) else i - 1

    # -- intrinsics -----------------------------------------------------------

    def get_intrinsic_matrices(self) -> np.ndarray:
        return intrinsic_matrices(self.fx, self.fy, self.cx, self.cy)

    def get_render_intrinsic_matrices(self) -> np.ndarray:
        """Intrinsics with the cx mirror flip applied — what every projection
        / integration / raycast consumes (reference o3d_utils.py:14-19)."""
        return mirror_cx(self.get_intrinsic_matrices(), self.widths)

    # -- persistence ------------------------------------------------------------

    def to_dict(self) -> dict:
        return {
            "directory_relative_path": self.directory_relative_path,
            "image_file_names": self.image_file_names,
            "timestamps": self.timestamps,
            "fx": self.fx,
            "fy": self.fy,
            "cx": self.cx,
            "cy": self.cy,
            "coordinate_system": self.transforms.coordinate_system.name,
            "positions": self.transforms.positions,
            "rotations": self.transforms.rotations,
            "widths": self.widths,
            "heights": self.heights,
        }

    def save(self, path: Path):
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(path, **self.to_dict())

    @staticmethod
    def parse_transforms(data: dict):
        data["transforms"] = Transforms(
            coordinate_system=CoordinateSystem[str(data.pop("coordinate_system"))],
            positions=np.asarray(data.pop("positions")),
            rotations=np.asarray(data.pop("rotations")),
        )

    @classmethod
    def from_dict(cls: Type[T], data: dict) -> T:
        data = dict(data)
        if "coordinate_system" in data:
            cls.parse_transforms(data)
        if isinstance(data.get("directory_relative_path"), np.ndarray):
            data["directory_relative_path"] = str(data["directory_relative_path"])
        return cls(**data)

    @classmethod
    def load(cls: Type[T], path: Path) -> T:
        data = dict(np.load(path, allow_pickle=False))
        return cls.from_dict(data)

    # -- fragmentation (the long-capture scaling mechanism) ---------------------

    def split(self: T, fragment_size: int) -> List[T]:
        """Split into contiguous fragments (reference camera_dataset.py:135-139).

        Fragmentation is the reference's long-sequence scaling strategy: local
        optimization per fragment, then a fragment-level global pose graph.
        The fragment axis is also the natural batch axis for device fan-out.
        """
        return [self[i : i + fragment_size] for i in range(0, len(self), fragment_size)]

    @classmethod
    def merge(cls: Type[T], datasets: List[T]) -> T:
        dicts = [d.to_dict() for d in datasets]
        merged = {}
        for key in dicts[0]:
            values = [d[key] for d in dicts]
            v0 = values[0]
            if isinstance(v0, np.ndarray) and v0.ndim >= 1:
                merged[key] = np.concatenate(values, axis=0)
            else:
                assert all(v == v0 for v in values), f"inconsistent scalar {key}"
                merged[key] = v0
        return cls.from_dict(merged)


@dataclass
class DepthDataset(CameraDataset):
    nears: np.ndarray
    fars: np.ndarray

    def to_dict(self) -> dict:
        d = super().to_dict()
        d["nears"] = self.nears
        d["fars"] = self.fars
        return d
