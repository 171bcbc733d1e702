"""FBX interop: PLY <-> FBX conversion, the counterpart of
mq3d_tpu/export/fbx.py.

The reference uses the commercial Aspose.3D library (reference:
scripts/utils/convert_ply_to_fbx_aspose.py:26-78, scripts/conversion/
convert_obj_to_fbx.py:49-500) to emit binary FBX.  The JAX build tries
`aspose.threed` first; this module leaves that probe out (no machine the
port runs on has the package) and always writes through the native binary
FBX 7.4 writer/reader (export/fbx_binary.py), with an ASCII FBX writer kept
for debugging/diff use.  The files are those the JAX build writes when
Aspose is absent.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

from mq3d_tpu_torch.dataio.ply import TriangleMesh, read_ply, write_ply_mesh
from mq3d_tpu_torch.export.fbx_binary import read_fbx_mesh as read_binary_fbx_mesh
from mq3d_tpu_torch.export.fbx_binary import write_fbx_mesh


def fbx_available() -> bool:
    return True  # the native binary writer is always available


def _write_ascii_fbx(mesh: TriangleMesh, path: Path):
    """Minimal FBX 7.3 ASCII file: one mesh node with vertex colors."""
    verts = np.asarray(mesh.vertices, np.float64)
    tris = np.asarray(mesh.triangles, np.int64)
    # FBX polygon encoding: last index of each polygon is bitwise-negated - 1.
    poly = tris.copy()
    poly[:, 2] = -poly[:, 2] - 1

    lines = [
        "; FBX 7.3.0 project file",
        "FBXHeaderExtension:  {",
        "\tFBXHeaderVersion: 1003",
        "\tFBXVersion: 7300",
        "}",
        "Definitions:  {",
        "\tVersion: 100",
        "\tCount: 2",
        '\tObjectType: "Geometry" { Count: 1 }',
        '\tObjectType: "Model" { Count: 1 }',
        "}",
        "Objects:  {",
        '\tGeometry: 1000, "Geometry::mesh", "Mesh" {',
        f"\t\tVertices: *{verts.size} {{ a: "
        + ",".join(f"{v:.6f}" for v in verts.reshape(-1))
        + " }",
        f"\t\tPolygonVertexIndex: *{poly.size} {{ a: "
        + ",".join(str(i) for i in poly.reshape(-1))
        + " }",
        "\t\tGeometryVersion: 124",
    ]
    if mesh.vertex_colors is not None:
        colors = np.asarray(mesh.vertex_colors, np.float64)
        if colors.max() > 1.0:
            colors = colors / 255.0
        rgba = np.concatenate([colors, np.ones((len(colors), 1))], axis=1)
        lines += [
            '\t\tLayerElementColor: 0 {',
            "\t\t\tVersion: 101",
            '\t\t\tName: "VertexColors"',
            '\t\t\tMappingInformationType: "ByVertice"',
            '\t\t\tReferenceInformationType: "Direct"',
            f"\t\t\tColors: *{rgba.size} {{ a: "
            + ",".join(f"{c:.6f}" for c in rgba.reshape(-1))
            + " }",
            "\t\t}",
            "\t\tLayer: 0 {",
            "\t\t\tVersion: 100",
            '\t\t\tLayerElement:  { Type: "LayerElementColor" TypedIndex: 0 }',
            "\t\t}",
        ]
    lines += [
        "\t}",
        '\tModel: 2000, "Model::mesh", "Mesh" {',
        "\t\tVersion: 232",
        "\t}",
        "}",
        "Connections:  {",
        "\tC: \"OO\",1000,2000",
        "\tC: \"OO\",2000,0",
        "}",
    ]
    Path(path).write_text("\n".join(lines))


def _read_ascii_fbx(path: Path) -> TriangleMesh:
    """Parse the subset of ASCII FBX that _write_ascii_fbx emits (and the
    equivalent sections of DCC exports): Vertices / PolygonVertexIndex /
    LayerElementColor arrays written as `Name: *N { a: v,v,... }`."""
    text = Path(path).read_text()

    def grab(name: str):
        m = re.search(
            rf"{name}:\s*\*\d+\s*{{\s*a:\s*([^}}]*)}}", text, re.DOTALL
        )
        if m is None:
            return None
        toks = [t for t in re.split(r"[\s,]+", m.group(1)) if t]
        return np.array(toks, np.float64)

    verts = grab("Vertices")
    pvi = grab("PolygonVertexIndex")
    if verts is None or pvi is None:
        raise ValueError(f"{path}: no mesh arrays found in ASCII FBX")
    pvi = pvi.astype(np.int64)
    tris = []
    start = 0
    for e in np.nonzero(pvi < 0)[0]:
        poly = pvi[start:e + 1].copy()
        poly[-1] = -poly[-1] - 1
        for k in range(1, len(poly) - 1):
            tris.append((poly[0], poly[k], poly[k + 1]))
        start = e + 1
    mesh = TriangleMesh(
        verts.reshape(-1, 3), np.asarray(tris, np.int64).reshape(-1, 3)
    )
    colors = grab("Colors")
    if colors is not None:
        rgba = colors.reshape(-1, 4)
        if len(rgba) >= len(mesh.vertices):
            mesh.vertex_colors = rgba[: len(mesh.vertices), :3]
    return mesh


def convert_ply_to_fbx(ply_path: Path, fbx_path: Path, ascii: bool = False):
    """PLY mesh -> FBX through the native binary FBX 7.4 writer (ASCII with
    ascii=True)."""
    mesh = read_ply(ply_path)
    if not isinstance(mesh, TriangleMesh):
        raise ValueError(f"{ply_path} does not contain a triangle mesh")
    if ascii:
        _write_ascii_fbx(mesh, fbx_path)
    else:
        write_fbx_mesh(fbx_path, mesh)


def read_fbx_mesh(fbx_path: Path) -> TriangleMesh:
    """Load a binary or ASCII FBX mesh without external dependencies."""
    with Path(fbx_path).open("rb") as f:
        head = f.read(21)
    if head.startswith(b"Kaydara FBX Binary"):
        return read_binary_fbx_mesh(fbx_path)
    return _read_ascii_fbx(fbx_path)


def convert_fbx_to_ply(fbx_path: Path, ply_path: Path):
    """FBX -> PLY (used by downsample_fbx_mesh) through the native binary
    and ASCII readers."""
    write_ply_mesh(ply_path, read_fbx_mesh(fbx_path))
