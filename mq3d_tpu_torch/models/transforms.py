"""Camera pose tables tagged with a coordinate system.

Re-design of the reference's Transforms model (reference:
scripts/models/transforms.py:41-288) on top of our own quaternion math
(mq3d_tpu_torch.geometry.quaternion) instead of scipy.  The npz layout
(`coordinate_system`, `positions`, `rotations`) is kept identical so
artifacts are interchangeable with the reference pipeline.

Conventions:
  positions: (N, 3) camera centers in world coordinates
  rotations: (N, 4) xyzw quaternions, camera-to-world
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from mq3d_tpu_torch.geometry import quaternion as quat
from mq3d_tpu_torch.geometry.coordinates import (
    CoordinateSystem,
    camera_basis,
    coordinate_transform_matrix,
)

__all__ = ["CoordinateSystem", "Transforms"]


def _np(x) -> np.ndarray:
    return np.asarray(x)


@dataclass
class Transforms:
    coordinate_system: CoordinateSystem
    positions: np.ndarray
    rotations: np.ndarray

    # -- pose accessors -----------------------------------------------------

    @property
    def positions_wc(self) -> np.ndarray:
        return self.positions

    @property
    def rotations_wc(self) -> np.ndarray:
        return self.rotations

    @property
    def positions_cw(self) -> np.ndarray:
        """World origin expressed in each camera frame: -R^T p."""
        inv = _np(quat.conjugate(self.rotations))
        return -_np(quat.rotate(inv, self.positions))

    @property
    def rotations_cw(self) -> np.ndarray:
        return _np(quat.conjugate(self.rotations))

    @property
    def extrinsics_cw(self) -> np.ndarray:
        """(N, 4, 4) camera-to-world matrices (float32, matching reference
        scripts/models/transforms.py:205-218)."""
        n = len(self.positions)
        R = _np(quat.as_matrix(self.rotations))
        out = np.zeros((n, 4, 4), dtype=np.float32)
        out[:, :3, :3] = R
        out[:, :3, 3] = self.positions
        out[:, 3, 3] = 1.0
        return out

    @property
    def extrinsics_wc(self) -> np.ndarray:
        """(N, 4, 4) world-to-camera matrices.

        The reference computes these as np.linalg.inv of the float32 cw
        matrices (transforms.py:215-216); we mirror that exactly, including
        inverting in float32, for bit-level artifact parity.
        """
        return np.linalg.inv(self.extrinsics_cw)

    # -- coordinate conversions ----------------------------------------------

    def convert_coordinate_system(
        self,
        target_coordinate_system: CoordinateSystem,
        is_camera: bool = False,
        skip_rotation: bool = False,
    ) -> "Transforms":
        """Re-express poses in another convention.

        Matches reference transforms.py:164-202: positions are rotated by
        R_conv; rotation matrices are conjugated R_conv @ R @ R_conv^T with
        optional camera-basis pre/post factors when the quaternions encode
        camera orientations rather than rigid-body orientations.
        """
        if self.coordinate_system == target_coordinate_system:
            return self

        R_conv = coordinate_transform_matrix(
            self.coordinate_system, target_coordinate_system
        )
        converted_positions = (R_conv @ self.positions.T).T

        if skip_rotation:
            return Transforms(
                coordinate_system=target_coordinate_system,
                positions=converted_positions,
                rotations=self.rotations,
            )

        rot_mats = _np(quat.as_matrix(self.rotations))
        if is_camera:
            rot_mats = rot_mats @ camera_basis(self.coordinate_system).T
        rot_mats = R_conv @ rot_mats @ R_conv.T
        if is_camera:
            rot_mats = rot_mats @ camera_basis(target_coordinate_system)

        return Transforms(
            coordinate_system=target_coordinate_system,
            positions=converted_positions,
            rotations=_np(quat.from_matrix(rot_mats)),
        )

    # -- composition ----------------------------------------------------------

    def apply_local_transform(
        self, local_position: np.ndarray, local_rotation: np.ndarray
    ) -> "Transforms":
        """Compose a fixed child offset in each pose's local frame
        (reference transforms.py:223-239; used to mount the passthrough
        camera rig on the interpolated HMD pose)."""
        rotated = _np(quat.rotate(self.rotations, np.asarray(local_position)))
        composed_pos = self.positions + rotated
        composed_rot = _np(quat.multiply(self.rotations, np.asarray(local_rotation)))
        return Transforms(self.coordinate_system, composed_pos, composed_rot)

    def apply_world_transform(
        self, delta_position: np.ndarray, delta_rotation: np.ndarray
    ) -> "Transforms":
        """Left-multiply a world-frame rigid delta onto every pose
        (reference transforms.py:242-258; applies optimized fragment poses
        back to member frames)."""
        delta_rotation = np.asarray(delta_rotation)
        rotated_pos = _np(quat.rotate(delta_rotation[None], self.positions))
        new_pos = rotated_pos + np.asarray(delta_position)
        new_rot = _np(quat.multiply(delta_rotation[None], self.rotations))
        return Transforms(self.coordinate_system, new_pos, new_rot)

    # -- persistence (npz layout identical to reference) ----------------------

    def to_dict(self) -> dict:
        return {
            "coordinate_system": self.coordinate_system,
            "positions": self.positions,
            "rotations": self.rotations,
        }

    def save(self, path: Path):
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(path, **self.to_dict())

    @classmethod
    def from_dict(cls, data) -> "Transforms":
        cs = data["coordinate_system"]
        if not isinstance(cs, CoordinateSystem):
            cs = CoordinateSystem[str(np.asarray(cs).item()).upper()] if str(
                np.asarray(cs)
            ).upper() in CoordinateSystem.__members__ else CoordinateSystem(
                str(np.asarray(cs).item())
            )
        return cls(
            coordinate_system=cs,
            positions=np.asarray(data["positions"]),
            rotations=np.asarray(data["rotations"]),
        )

    @classmethod
    def load(cls, path: Path) -> "Transforms":
        data = dict(np.load(path, allow_pickle=False))
        # np.savez stores the enum via its str(); accept both name and value.
        raw = str(data["coordinate_system"])
        raw = raw.replace("CoordinateSystem.", "")
        if raw in CoordinateSystem.__members__:
            cs = CoordinateSystem[raw]
        else:
            cs = CoordinateSystem(raw)
        return cls(cs, data["positions"], data["rotations"])
