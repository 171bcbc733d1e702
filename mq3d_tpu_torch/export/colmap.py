"""COLMAP sparse-model I/O (text + binary), written from the format spec;
the counterpart of mq3d_tpu/export/colmap.py, byte for byte.

The reference vendors COLMAP's own reader/writer (reference:
scripts/third_party/colmap/read_and_write_model.py:38-566); we implement
the same on-disk formats independently:

  cameras.bin   <num_cameras u64> then per camera:
                <camera_id i32> <model_id i32> <width u64> <height u64>
                <params f64 x num_params(model)>
  images.bin    <num_images u64> then per image:
                <image_id i32> <qvec f64 x4 (w,x,y,z)> <tvec f64 x3>
                <camera_id i32> <name utf8 \\0> <num_points2D u64>
                <x f64 y f64 point3D_id i64> x n
  points3D.bin  <num_points u64> then per point:
                <point3D_id i64> <xyz f64 x3> <rgb u8 x3> <error f64>
                <track_len u64> <image_id i32 point2D_idx i32> x track_len

Camera model ids follow COLMAP's enumeration (SIMPLE_PINHOLE=0, PINHOLE=1,
SIMPLE_RADIAL=2, RADIAL=3, OPENCV=4, ...).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict

import numpy as np

CAMERA_MODEL_IDS = {
    "SIMPLE_PINHOLE": (0, 3),
    "PINHOLE": (1, 4),
    "SIMPLE_RADIAL": (2, 4),
    "RADIAL": (3, 5),
    "OPENCV": (4, 8),
    "OPENCV_FISHEYE": (5, 8),
    "FULL_OPENCV": (6, 12),
    "FOV": (7, 5),
    "SIMPLE_RADIAL_FISHEYE": (8, 4),
    "RADIAL_FISHEYE": (9, 5),
    "THIN_PRISM_FISHEYE": (10, 12),
}
MODEL_NAME_BY_ID = {v[0]: (k, v[1]) for k, v in CAMERA_MODEL_IDS.items()}


@dataclass
class Camera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class Image:
    id: int
    qvec: np.ndarray  # (4,) w, x, y, z — world-to-camera rotation
    tvec: np.ndarray  # (3,) world-to-camera translation
    camera_id: int
    name: str
    xys: np.ndarray = field(default_factory=lambda: np.zeros((0, 2)))
    point3D_ids: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))


@dataclass
class Point3D:
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float = 0.0
    image_ids: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    point2D_idxs: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))


def qvec2rotmat(qvec: np.ndarray) -> np.ndarray:
    """(w, x, y, z) quaternion -> rotation matrix (COLMAP convention)."""
    w, x, y, z = qvec
    return np.array(
        [
            [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
            [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w],
            [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y],
        ]
    )


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> (w, x, y, z)."""
    from mq3d_tpu_torch.geometry import quaternion as quat

    q = np.asarray(quat.from_matrix(np.asarray(R)))  # xyzw
    return np.array([q[3], q[0], q[1], q[2]])


# ---------------------------------------------------------------------------
# binary writers
# ---------------------------------------------------------------------------

def write_cameras_binary(cameras: Dict[int, Camera], path: Path):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cam in cameras.values():
            model_id, num_params = CAMERA_MODEL_IDS[cam.model]
            f.write(struct.pack("<iiQQ", cam.id, model_id, cam.width, cam.height))
            params = np.asarray(cam.params, np.float64)
            assert len(params) == num_params, (cam.model, len(params))
            f.write(struct.pack(f"<{num_params}d", *params))


def write_images_binary(images: Dict[int, Image], path: Path):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<i", im.id))
            f.write(struct.pack("<4d", *np.asarray(im.qvec, np.float64)))
            f.write(struct.pack("<3d", *np.asarray(im.tvec, np.float64)))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            n = len(im.xys)
            f.write(struct.pack("<Q", n))
            for k in range(n):
                f.write(
                    struct.pack(
                        "<ddq", im.xys[k, 0], im.xys[k, 1], int(im.point3D_ids[k])
                    )
                )


def write_points3D_binary(points3D: Dict[int, Point3D], path: Path):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(points3D)))
        for pt in points3D.values():
            f.write(struct.pack("<q", pt.id))
            f.write(struct.pack("<3d", *np.asarray(pt.xyz, np.float64)))
            f.write(struct.pack("<3B", *np.asarray(pt.rgb, np.uint8)))
            f.write(struct.pack("<d", float(pt.error)))
            n = len(pt.image_ids)
            f.write(struct.pack("<Q", n))
            for k in range(n):
                f.write(struct.pack("<ii", int(pt.image_ids[k]), int(pt.point2D_idxs[k])))


# ---------------------------------------------------------------------------
# binary readers
# ---------------------------------------------------------------------------

def read_cameras_binary(path: Path) -> Dict[int, Camera]:
    cameras = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            cam_id, model_id, width, height = struct.unpack("<iiQQ", f.read(24))
            model, num_params = MODEL_NAME_BY_ID[model_id]
            params = np.asarray(struct.unpack(f"<{num_params}d", f.read(8 * num_params)))
            cameras[cam_id] = Camera(cam_id, model, width, height, params)
    return cameras


def read_images_binary(path: Path) -> Dict[int, Image]:
    images = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            (image_id,) = struct.unpack("<i", f.read(4))
            qvec = np.asarray(struct.unpack("<4d", f.read(32)))
            tvec = np.asarray(struct.unpack("<3d", f.read(24)))
            (camera_id,) = struct.unpack("<i", f.read(4))
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n2d,) = struct.unpack("<Q", f.read(8))
            xys = np.zeros((n2d, 2))
            ids = np.zeros(n2d, np.int64)
            for k in range(n2d):
                x, y, pid = struct.unpack("<ddq", f.read(24))
                xys[k] = (x, y)
                ids[k] = pid
            images[image_id] = Image(
                image_id, qvec, tvec, camera_id, name.decode("utf-8"), xys, ids
            )
    return images


def read_points3D_binary(path: Path) -> Dict[int, Point3D]:
    points = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            (pid,) = struct.unpack("<q", f.read(8))
            xyz = np.asarray(struct.unpack("<3d", f.read(24)))
            rgb = np.asarray(struct.unpack("<3B", f.read(3)))
            (error,) = struct.unpack("<d", f.read(8))
            (tl,) = struct.unpack("<Q", f.read(8))
            img_ids = np.zeros(tl, np.int64)
            p2d = np.zeros(tl, np.int64)
            for k in range(tl):
                a, b = struct.unpack("<ii", f.read(8))
                img_ids[k] = a
                p2d[k] = b
            points[pid] = Point3D(pid, xyz, rgb, float(error), img_ids, p2d)
    return points


# ---------------------------------------------------------------------------
# text writers (for completeness / debugging)
# ---------------------------------------------------------------------------

def write_cameras_text(cameras: Dict[int, Camera], path: Path):
    with open(path, "w") as f:
        f.write("# Camera list with one line of data per camera:\n")
        f.write("#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        f.write(f"# Number of cameras: {len(cameras)}\n")
        for cam in cameras.values():
            params = " ".join(repr(float(p)) for p in cam.params)
            f.write(f"{cam.id} {cam.model} {cam.width} {cam.height} {params}\n")


def write_images_text(images: Dict[int, Image], path: Path):
    with open(path, "w") as f:
        f.write("# Image list with two lines of data per image:\n")
        f.write("#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n")
        f.write("#   POINTS2D[] as (X, Y, POINT3D_ID)\n")
        f.write(f"# Number of images: {len(images)}\n")
        for im in images.values():
            q = " ".join(repr(float(v)) for v in im.qvec)
            t = " ".join(repr(float(v)) for v in im.tvec)
            f.write(f"{im.id} {q} {t} {im.camera_id} {im.name}\n")
            pts = " ".join(
                f"{x} {y} {pid}"
                for (x, y), pid in zip(im.xys, im.point3D_ids)
            )
            f.write(pts + "\n")


def write_points3D_text(points3D: Dict[int, Point3D], path: Path):
    with open(path, "w") as f:
        f.write("# 3D point list with one line of data per point:\n")
        f.write("#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, TRACK[] as (IMAGE_ID, POINT2D_IDX)\n")
        f.write(f"# Number of points: {len(points3D)}\n")
        for pt in points3D.values():
            xyz = " ".join(repr(float(v)) for v in pt.xyz)
            rgb = " ".join(str(int(v)) for v in pt.rgb)
            track = " ".join(
                f"{int(i)} {int(k)}" for i, k in zip(pt.image_ids, pt.point2D_idxs)
            )
            f.write(f"{pt.id} {xyz} {rgb} {pt.error} {track}\n")


# ---------------------------------------------------------------------------
# text readers
# ---------------------------------------------------------------------------

def _data_lines(path: Path):
    """Yield non-comment, non-empty lines (COLMAP text files use '#')."""
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                yield line


def read_cameras_text(path: Path) -> Dict[int, Camera]:
    cameras = {}
    for line in _data_lines(path):
        parts = line.split()
        cam_id = int(parts[0])
        model = parts[1]
        width, height = int(parts[2]), int(parts[3])
        params = np.asarray([float(p) for p in parts[4:]], np.float64)
        assert len(params) == CAMERA_MODEL_IDS[model][1], (model, len(params))
        cameras[cam_id] = Camera(cam_id, model, width, height, params)
    return cameras


def read_images_text(path: Path) -> Dict[int, Image]:
    """Two data lines per image: pose line, then the (possibly empty)
    POINTS2D line — which is why this is not a simple per-line loop."""
    images = {}
    lines = list(_data_lines_with_blanks(path))
    i = 0
    while i < len(lines):
        parts = lines[i].split()
        image_id = int(parts[0])
        qvec = np.asarray([float(v) for v in parts[1:5]])
        tvec = np.asarray([float(v) for v in parts[5:8]])
        camera_id = int(parts[8])
        name = " ".join(parts[9:])
        elems = lines[i + 1].split() if i + 1 < len(lines) else []
        xys = np.asarray(
            [(float(elems[k]), float(elems[k + 1])) for k in range(0, len(elems), 3)]
        ).reshape(-1, 2)
        ids = np.asarray(
            [int(elems[k + 2]) for k in range(0, len(elems), 3)], np.int64
        )
        images[image_id] = Image(image_id, qvec, tvec, camera_id, name, xys, ids)
        i += 2
    return images


def _data_lines_with_blanks(path: Path):
    """Like _data_lines but keeps empty data lines — an image with zero
    2D points writes an empty POINTS2D line that must still be consumed."""
    out = []
    with open(path) as f:
        for line in f:
            s = line.strip()
            if s.startswith("#"):
                continue
            out.append(s)
    # Trailing newlines at EOF produce spurious empty entries; drop trailing
    # blanks that cannot be data.  A blank is legitimate only as the second
    # line of a pair (an empty POINTS2D list) under a non-blank header, so
    # pop while the last blank sits in a header slot (odd length) or its
    # would-be header is itself blank (an all-blank trailing pair).
    while out and not out[-1] and (len(out) % 2 or not out[-2]):
        out.pop()
    return out


def read_points3D_text(path: Path) -> Dict[int, Point3D]:
    points = {}
    for line in _data_lines(path):
        parts = line.split()
        pid = int(parts[0])
        xyz = np.asarray([float(v) for v in parts[1:4]])
        rgb = np.asarray([int(v) for v in parts[4:7]], np.uint8)
        error = float(parts[7])
        track = parts[8:]
        img_ids = np.asarray([int(track[k]) for k in range(0, len(track), 2)],
                             np.int64)
        p2d = np.asarray([int(track[k + 1]) for k in range(0, len(track), 2)],
                         np.int64)
        points[pid] = Point3D(pid, xyz, rgb, error, img_ids, p2d)
    return points


def write_model(
    cameras: Dict[int, Camera],
    images: Dict[int, Image],
    points3D: Dict[int, Point3D],
    path: Path,
    ext: str = ".bin",
):
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    if ext == ".bin":
        write_cameras_binary(cameras, path / "cameras.bin")
        write_images_binary(images, path / "images.bin")
        write_points3D_binary(points3D, path / "points3D.bin")
    else:
        write_cameras_text(cameras, path / "cameras.txt")
        write_images_text(images, path / "images.txt")
        write_points3D_text(points3D, path / "points3D.txt")
    return path


def read_model(path: Path, ext: str | None = None):
    """Read a COLMAP model directory.  ext=None autodetects: binary when
    cameras.bin exists, else text (matches the reference's detect-order,
    reference: scripts/third_party/colmap/read_and_write_model.py:508-528)."""
    path = Path(path)
    if ext is None:
        ext = ".bin" if (path / "cameras.bin").exists() else ".txt"
    if ext == ".bin":
        return (
            read_cameras_binary(path / "cameras.bin"),
            read_images_binary(path / "images.bin"),
            read_points3D_binary(path / "points3D.bin"),
        )
    return (
        read_cameras_text(path / "cameras.txt"),
        read_images_text(path / "images.txt"),
        read_points3D_text(path / "points3D.txt"),
    )
