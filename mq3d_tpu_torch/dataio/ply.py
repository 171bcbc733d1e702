"""Minimal binary PLY / PCD codecs (numpy, no external geometry libs).

The reference persists meshes and point clouds through Open3D's C++ IO
(reference: scripts/dataio/reconstruction_data_io.py:42-145).  We write the
same formats with numpy so artifacts remain interchangeable:

  *.ply  binary_little_endian 1.0; vertices (+normals, +uchar colors),
         triangle faces as (uchar count, 3x int32)
  *.pcd  PCD v0.7 binary, FIELDS x y z [normal_x normal_y normal_z]
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np


@dataclass
class PointCloud:
    points: np.ndarray  # (N, 3) float
    normals: Optional[np.ndarray] = None
    colors: Optional[np.ndarray] = None  # float in [0,1] or uint8

    def __len__(self):
        return len(self.points)


@dataclass
class TriangleMesh:
    vertices: np.ndarray  # (N, 3) float
    triangles: np.ndarray  # (M, 3) int
    vertex_normals: Optional[np.ndarray] = None
    vertex_colors: Optional[np.ndarray] = None  # float in [0,1] or uint8

    def __len__(self):
        return len(self.vertices)


def _color_u8(colors: np.ndarray) -> np.ndarray:
    if colors.dtype == np.uint8:
        return colors
    return np.clip(np.rint(colors * 255.0), 0, 255).astype(np.uint8)


def write_ply(
    path: Path,
    vertices: np.ndarray,
    triangles: Optional[np.ndarray] = None,
    normals: Optional[np.ndarray] = None,
    colors: Optional[np.ndarray] = None,
):
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    vertices = np.asarray(vertices, dtype=np.float32)
    n = len(vertices)

    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    fields = [("x", vertices[:, 0]), ("y", vertices[:, 1]), ("z", vertices[:, 2])]
    for name, col in fields:
        header.append(f"property float {name}")
    if normals is not None:
        normals = np.asarray(normals, dtype=np.float32)
        for i, name in enumerate(("nx", "ny", "nz")):
            header.append(f"property float {name}")
            fields.append((name, normals[:, i]))
    color_u8 = None
    if colors is not None:
        color_u8 = _color_u8(np.asarray(colors))
        for name in ("red", "green", "blue"):
            header.append(f"property uchar {name}")

    ntri = 0 if triangles is None else len(triangles)
    if triangles is not None:
        header += [f"element face {ntri}", "property list uchar int vertex_indices"]
    header.append("end_header")

    # Interleave vertex record via structured array.
    dt = [(name, "<f4") for name, _ in fields]
    if color_u8 is not None:
        dt += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    rec = np.empty(n, dtype=dt)
    for name, col in fields:
        rec[name] = col
    if color_u8 is not None:
        rec["red"] = color_u8[:, 0]
        rec["green"] = color_u8[:, 1]
        rec["blue"] = color_u8[:, 2]

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(rec.tobytes())
        if triangles is not None and ntri > 0:
            tri = np.asarray(triangles, dtype=np.int32)
            face = np.empty(ntri, dtype=[("cnt", "u1"), ("idx", "<i4", (3,))])
            face["cnt"] = 3
            face["idx"] = tri
            f.write(face.tobytes())


def write_ply_pointcloud(path: Path, pcd: PointCloud):
    write_ply(path, pcd.points, None, pcd.normals, pcd.colors)


def write_ply_mesh(path: Path, mesh: TriangleMesh):
    write_ply(path, mesh.vertices, mesh.triangles, mesh.vertex_normals, mesh.vertex_colors)


_PLY_TYPES = {
    "char": "i1", "uchar": "u1", "int8": "i1", "uint8": "u1",
    "short": "i2", "ushort": "u2", "int16": "i2", "uint16": "u2",
    "int": "i4", "uint": "u4", "int32": "i4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def read_ply(path: Path):
    """Read binary or ascii PLY.  Returns (TriangleMesh | PointCloud)."""
    path = Path(path)
    with open(path, "rb") as f:
        data = f.read()

    end = data.find(b"end_header\n")
    if end < 0:
        raise ValueError(f"{path}: not a PLY file")
    header_lines = data[:end].decode("ascii", errors="replace").splitlines()
    body = data[end + len(b"end_header\n") :]

    if header_lines[0].strip() != "ply":
        raise ValueError(f"{path}: missing ply magic")
    fmt = "binary_little_endian"
    elements = []  # list of (name, count, [(prop_name, dtype_or_list)])
    for line in header_lines[1:]:
        parts = line.strip().split()
        if not parts or parts[0] == "comment":
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append((parts[4], ("list", _PLY_TYPES[parts[2]], _PLY_TYPES[parts[3]])))
            else:
                elements[-1][2].append((parts[2], _PLY_TYPES[parts[1]]))

    parsed = {}
    if fmt == "ascii":
        tokens = body.split()
        pos = 0
        for name, count, props in elements:
            cols = {p: [] for p, _ in props}
            for _ in range(count):
                for p, t in props:
                    if isinstance(t, tuple):
                        cnt = int(tokens[pos]); pos += 1
                        cols[p].append([float(tokens[pos + k]) for k in range(cnt)])
                        pos += cnt
                    else:
                        cols[p].append(float(tokens[pos])); pos += 1
            parsed[name] = {p: np.asarray(v) for p, v in cols.items()}
    else:
        endian = "<" if "little" in fmt else ">"
        offset = 0
        for name, count, props in elements:
            has_list = any(isinstance(t, tuple) for _, t in props)
            if not has_list:
                dt = np.dtype([(p, endian + t) for p, t in props])
                arr = np.frombuffer(body, dtype=dt, count=count, offset=offset)
                offset += dt.itemsize * count
                parsed[name] = {p: arr[p] for p, _ in props}
            else:
                # Fast path: single list property with constant count 3
                # (triangle faces) — probe the first record.
                p, (_, cnt_t, idx_t) = props[0][0], props[0][1]
                cnt_dt = np.dtype(endian + cnt_t)
                idx_dt = np.dtype(endian + idx_t)
                if count > 0:
                    first_cnt = int(np.frombuffer(body, cnt_dt, 1, offset)[0])
                else:
                    first_cnt = 3
                rec_dt = np.dtype([("cnt", endian + cnt_t), ("idx", endian + idx_t, (first_cnt,))])
                arr = np.frombuffer(body, dtype=rec_dt, count=count, offset=offset)
                if count > 0 and not (arr["cnt"] == first_cnt).all():
                    raise ValueError(f"{path}: variable-length face lists unsupported")
                offset += rec_dt.itemsize * count
                parsed[name] = {p: arr["idx"]}

    v = parsed.get("vertex", {})
    pts = np.stack([v["x"], v["y"], v["z"]], axis=-1).astype(np.float64) if "x" in v else np.zeros((0, 3))
    normals = (
        np.stack([v["nx"], v["ny"], v["nz"]], axis=-1).astype(np.float64)
        if "nx" in v
        else None
    )
    colors = (
        np.stack([v["red"], v["green"], v["blue"]], axis=-1).astype(np.float64) / 255.0
        if "red" in v
        else None
    )
    face = parsed.get("face")
    if face:
        tri = np.asarray(next(iter(face.values())), dtype=np.int64)
        return TriangleMesh(pts, tri, vertex_normals=normals, vertex_colors=colors)
    return PointCloud(pts, normals=normals, colors=colors)


# ---------------------------------------------------------------------------
# PCD (fragment point-cloud caches; reference uses Open3D .pcd at
# cache/pcd/<SIDE>_fragment_<i>.pcd). We write plain `binary`; reading also
# supports ascii and PCL's LZF `binary_compressed` (what Open3D writes with
# compressed=True, reference reconstruction_data_io.py:39).
# ---------------------------------------------------------------------------


def _lzf_decompress(data: bytes, expected_size: int) -> bytes:
    """LibLZF decompression (the PCL/Open3D PCD codec)."""
    out = bytearray(expected_size)
    i = 0
    o = 0
    n = len(data)
    while i < n:
        ctrl = data[i]
        i += 1
        if ctrl < 32:  # literal run of ctrl+1 bytes
            run = ctrl + 1
            out[o : o + run] = data[i : i + run]
            i += run
            o += run
        else:  # back reference
            length = ctrl >> 5
            if length == 7:
                length += data[i]
                i += 1
            length += 2
            ref = o - ((ctrl & 0x1F) << 8) - data[i] - 1
            i += 1
            # Overlapping copies must go byte-by-byte.
            if ref + length <= o:
                out[o : o + length] = out[ref : ref + length]
                o += length
            else:
                for _ in range(length):
                    out[o] = out[ref]
                    o += 1
                    ref += 1
    return bytes(out[:o])

def write_pcd(path: Path, pcd: PointCloud):
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    pts = np.asarray(pcd.points, dtype=np.float32)
    fields = ["x", "y", "z"]
    cols = [pts[:, 0], pts[:, 1], pts[:, 2]]
    if pcd.normals is not None:
        fields += ["normal_x", "normal_y", "normal_z"]
        nrm = np.asarray(pcd.normals, dtype=np.float32)
        cols += [nrm[:, 0], nrm[:, 1], nrm[:, 2]]
    n = len(pts)
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"FIELDS {' '.join(fields)}\n"
        f"SIZE {' '.join(['4'] * len(fields))}\n"
        f"TYPE {' '.join(['F'] * len(fields))}\n"
        f"COUNT {' '.join(['1'] * len(fields))}\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\nDATA binary\n"
    )
    rec = np.stack(cols, axis=-1).astype("<f4")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rec.tobytes())


def read_pcd(path: Path) -> PointCloud:
    with open(path, "rb") as f:
        data = f.read()
    # Header ends at the newline after the DATA line.
    idx = data.find(b"DATA")
    nl = data.find(b"\n", idx)
    header = data[:nl].decode("ascii").splitlines()
    body = data[nl + 1 :]
    meta = {}
    for line in header:
        if line.startswith("#"):
            continue
        key, _, rest = line.partition(" ")
        meta[key] = rest.split()
    fields = meta["FIELDS"]
    sizes = [int(s) for s in meta["SIZE"]]
    types = meta["TYPE"]
    n = int(meta["POINTS"][0])
    mode = meta["DATA"][0]
    np_types = {("F", 4): "<f4", ("F", 8): "<f8", ("I", 4): "<i4", ("U", 4): "<u4", ("U", 1): "u1"}
    dt = np.dtype([(f, np_types[(t, s)]) for f, t, s in zip(fields, types, sizes)])
    if mode == "binary":
        arr = np.frombuffer(body, dtype=dt, count=n)
    elif mode == "ascii":
        arr = np.loadtxt(body.decode("ascii").splitlines(), dtype=dt)
    elif mode == "binary_compressed":
        # Open3D/PCL compressed layout: u32 compressed_size, u32
        # uncompressed_size, LZF block holding the data field-major (SoA).
        import struct as _struct

        comp_size, uncomp_size = _struct.unpack_from("<II", body, 0)
        raw = _lzf_decompress(body[8 : 8 + comp_size], uncomp_size)
        arr = np.empty(n, dtype=dt)
        off = 0
        for f, t, s in zip(fields, types, sizes):
            fdt = np.dtype(np_types[(t, s)])
            col = np.frombuffer(raw, dtype=fdt, count=n, offset=off)
            arr[f] = col
            off += n * fdt.itemsize
    else:
        raise ValueError(f"Unsupported PCD DATA mode: {mode}")
    pts = np.stack([arr["x"], arr["y"], arr["z"]], axis=-1).astype(np.float64)
    normals = None
    if "normal_x" in fields:
        normals = np.stack(
            [arr["normal_x"], arr["normal_y"], arr["normal_z"]], axis=-1
        ).astype(np.float64)
    return PointCloud(pts, normals=normals)
