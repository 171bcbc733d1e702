"""OBJ/MTL import with texture-to-vertex-color baking, the counterpart of
mq3d_tpu/export/obj.py (textures read through utils/png.py: no PIL, no cv2).

Re-design of the reference's OBJ+MTL+texture -> vertex-colored FBX converter
(reference: scripts/conversion/convert_obj_to_fbx.py:49-500): parse OBJ
geometry and UVs, resolve the diffuse texture from the MTL, sample it at
each vertex's UV to bake vertex colors, and return a TriangleMesh ready for
FBX/PLY export.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from mq3d_tpu_torch.dataio.ply import TriangleMesh


def parse_mtl(path: Path) -> Dict[str, Dict]:
    """Material name -> {map_Kd: path, Kd: (r,g,b)}."""
    materials: Dict[str, Dict] = {}
    current = None
    if not path.exists():
        return materials
    for line in path.read_text(errors="replace").splitlines():
        parts = line.strip().split()
        if not parts or parts[0].startswith("#"):
            continue
        if parts[0] == "newmtl":
            current = parts[1]
            materials[current] = {}
        elif current and parts[0] == "map_Kd":
            materials[current]["map_Kd"] = " ".join(parts[1:])
        elif current and parts[0] == "Kd" and len(parts) >= 4:
            materials[current]["Kd"] = tuple(float(v) for v in parts[1:4])
    return materials


def load_obj(path: Path) -> Tuple[TriangleMesh, Optional[np.ndarray], Optional[str]]:
    """Parse OBJ. Returns (mesh, per-vertex uv or None, mtl filename)."""
    path = Path(path)
    verts, uvs = [], []
    faces, face_uvs = [], []
    mtllib = None

    for line in path.read_text(errors="replace").splitlines():
        parts = line.strip().split()
        if not parts or parts[0].startswith("#"):
            continue
        if parts[0] == "v":
            verts.append([float(v) for v in parts[1:4]])
        elif parts[0] == "vt":
            uvs.append([float(parts[1]), float(parts[2])])
        elif parts[0] == "mtllib":
            mtllib = " ".join(parts[1:])
        elif parts[0] == "f":
            refs = []
            for token in parts[1:]:
                comps = token.split("/")
                vi = int(comps[0])
                ti = int(comps[1]) if len(comps) > 1 and comps[1] else 0
                refs.append((vi, ti))
            # Fan-triangulate polygons.
            for k in range(1, len(refs) - 1):
                faces.append([refs[0][0], refs[k][0], refs[k + 1][0]])
                face_uvs.append([refs[0][1], refs[k][1], refs[k + 1][1]])

    verts = np.asarray(verts, np.float64)
    n = len(verts)
    faces = np.asarray(faces, np.int64)
    faces = np.where(faces > 0, faces - 1, faces + n)  # negative indices

    vertex_uv = None
    if uvs and face_uvs:
        uvs_arr = np.asarray(uvs, np.float64)
        face_uvs = np.asarray(face_uvs, np.int64)
        has_uv = face_uvs > 0
        face_uvs = np.where(has_uv, face_uvs - 1, 0)
        vertex_uv = np.zeros((n, 2))
        seen = np.zeros(n, bool)
        flat_v = faces.reshape(-1)
        flat_t = face_uvs.reshape(-1)
        flat_has = has_uv.reshape(-1)
        # Last-writer-wins assignment of a UV per vertex (adequate for baked
        # texture-to-vertex-color transfer on dense reconstruction meshes).
        vertex_uv[flat_v[flat_has]] = uvs_arr[flat_t[flat_has]]
        seen[flat_v[flat_has]] = True
        if not seen.any():
            vertex_uv = None

    return TriangleMesh(verts, faces), vertex_uv, mtllib


def bake_texture_to_vertex_colors(
    mesh: TriangleMesh,
    vertex_uv: Optional[np.ndarray],
    obj_path: Path,
    mtllib: Optional[str],
) -> TriangleMesh:
    """Sample the diffuse texture at vertex UVs -> vertex colors."""
    obj_dir = Path(obj_path).parent
    color = None
    if mtllib:
        materials = parse_mtl(obj_dir / mtllib)
        tex_name = None
        kd = None
        for m in materials.values():
            tex_name = tex_name or m.get("map_Kd")
            kd = kd or m.get("Kd")
        if tex_name and vertex_uv is not None:
            from mq3d_tpu_torch.utils.png import imread_bgr

            tex = imread_bgr(obj_dir / tex_name)
            if tex is not None:
                h, w = tex.shape[:2]
                u = np.clip(vertex_uv[:, 0], 0, 1) * (w - 1)
                # OBJ v runs bottom-up.
                v = (1.0 - np.clip(vertex_uv[:, 1], 0, 1)) * (h - 1)
                rgb = tex[v.astype(int), u.astype(int)][:, ::-1]
                color = rgb.astype(np.float64) / 255.0
        if color is None and kd is not None:
            color = np.tile(np.asarray(kd, np.float64), (len(mesh.vertices), 1))
    if color is not None:
        mesh.vertex_colors = color
    return mesh


def convert_obj_to_mesh(obj_path: Path) -> TriangleMesh:
    mesh, vertex_uv, mtllib = load_obj(obj_path)
    return bake_texture_to_vertex_colors(mesh, vertex_uv, obj_path, mtllib)
