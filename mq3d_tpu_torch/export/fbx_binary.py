"""Native binary FBX 7.4 reader/writer, the counterpart of
mq3d_tpu/export/fbx_binary.py: the same mesh gives the same bytes.

The reference converts PLY meshes to *binary* FBX through the commercial
Aspose.3D library (reference: scripts/utils/convert_ply_to_fbx_aspose.py:
26-78); this module implements the binary container directly from the
publicly documented format:

  header   "Kaydara FBX Binary  \\x00\\x1a\\x00" + uint32 version
  node     end_offset(u32) num_props(u32) prop_len(u32) name_len(u8) name
           properties... children... [13-byte null sentinel when nested]
  props    primitives C/Y/I/L/F/D; arrays b/i/l/f/d with
           (count u32, encoding u32, byte_len u32) and zlib at encoding=1;
           raw/string R/S with u32 length prefix
  footer   16-byte code + pad-to-16 + version + 120 zeros + magic

Only the subset a mesh document needs is produced (Geometry with vertices,
polygons, optional per-vertex colors + normals, a Model, Connections), but
the reader walks ANY conforming file, so round-trips and third-party files
both load.  DCC importers (Blender, assimp) accept a zeroed footer code;
none of the open readers validate it.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from mq3d_tpu_torch.dataio.ply import TriangleMesh

_MAGIC = b"Kaydara FBX Binary  \x00\x1a\x00"
# Trailing bytes every stock writer emits after the footer code + version.
_FOOTER_MAGIC = bytes(
    [0xF8, 0x5A, 0x8C, 0x6A, 0xDE, 0xF5, 0xD9, 0x7E,
     0xEC, 0xE9, 0x0C, 0xE3, 0x75, 0x8F, 0x29, 0x0B]
)

_PRIM = {b"C": "<?", b"Y": "<h", b"I": "<i", b"L": "<q",
         b"F": "<f", b"D": "<d"}
_ARR = {b"b": np.dtype("<u1"), b"i": np.dtype("<i4"),
        b"l": np.dtype("<i8"), b"f": np.dtype("<f4"),
        b"d": np.dtype("<f8")}
_ARR_FOR_DTYPE = {"int32": b"i", "int64": b"l",
                  "float32": b"f", "float64": b"d", "uint8": b"b"}


@dataclass
class FbxNode:
    """One record of the FBX node tree."""

    name: str
    props: list = field(default_factory=list)
    children: list = field(default_factory=list)

    def find(self, name: str):
        for c in self.children:
            if c.name == name:
                return c
        return None

    def find_all(self, name: str):
        return [c for c in self.children if c.name == name]


# ---------------------------------------------------------------------------
# writer


def _encode_prop(v) -> bytes:
    if isinstance(v, bool):
        return b"C" + struct.pack("<?", v)
    if isinstance(v, int):
        if -(2 ** 31) <= v < 2 ** 31:
            return b"I" + struct.pack("<i", v)
        return b"L" + struct.pack("<q", v)
    if isinstance(v, float):
        return b"D" + struct.pack("<d", v)
    if isinstance(v, str):
        raw = v.encode("utf-8")
        return b"S" + struct.pack("<I", len(raw)) + raw
    if isinstance(v, bytes):
        return b"R" + struct.pack("<I", len(v)) + v
    if isinstance(v, np.ndarray):
        code = _ARR_FOR_DTYPE[str(v.dtype)]
        raw = np.ascontiguousarray(v.reshape(-1)).tobytes()
        comp = zlib.compress(raw)
        if len(comp) < len(raw):
            return (code + struct.pack("<III", v.size, 1, len(comp)) + comp)
        return code + struct.pack("<III", v.size, 0, len(raw)) + raw
    raise TypeError(f"unsupported FBX property type {type(v)}")


def _encode_node(node: FbxNode, offset: int) -> bytes:
    """Serialize one node at absolute file position `offset`."""
    name = node.name.encode("utf-8")
    props = b"".join(_encode_prop(p) for p in node.props)
    head_len = 13 + len(name)
    body = bytearray()
    pos = offset + head_len + len(props)
    if node.children:
        for c in node.children:
            blob = _encode_node(c, pos + len(body))
            body += blob
        body += b"\x00" * 13  # child-list sentinel
    end = offset + head_len + len(props) + len(body)
    return (
        struct.pack("<III", end, len(node.props), len(props))
        + struct.pack("<B", len(name))
        + name
        + props
        + bytes(body)
    )


def write_fbx(path: Path, nodes: list[FbxNode], version: int = 7400) -> None:
    """Write a binary FBX file from a list of top-level nodes."""
    out = bytearray(_MAGIC + struct.pack("<I", version))
    for n in nodes:
        out += _encode_node(n, len(out))
    out += b"\x00" * 13  # top-level sentinel
    # Footer: 16-byte code (zeroed — not validated by open readers),
    # zero-pad so the version field starts 16-aligned, version, 120 zeros,
    # closing magic.
    out += b"\x00" * 16
    out += b"\x00" * ((16 - len(out) % 16) % 16)
    out += struct.pack("<I", version)
    out += b"\x00" * 120
    out += _FOOTER_MAGIC
    Path(path).write_bytes(bytes(out))


# ---------------------------------------------------------------------------
# reader


def _read_props(buf: memoryview, n: int):
    props = []
    pos = 0
    for _ in range(n):
        code = bytes(buf[pos:pos + 1])
        pos += 1
        if code in _PRIM:
            fmt = _PRIM[code]
            size = struct.calcsize(fmt)
            props.append(struct.unpack_from(fmt, buf, pos)[0])
            pos += size
        elif code in _ARR:
            count, enc, blen = struct.unpack_from("<III", buf, pos)
            pos += 12
            raw = bytes(buf[pos:pos + blen])
            pos += blen
            if enc == 1:
                raw = zlib.decompress(raw)
            props.append(np.frombuffer(raw, _ARR[code], count))
        elif code == b"S":
            (slen,) = struct.unpack_from("<I", buf, pos)
            pos += 4
            props.append(bytes(buf[pos:pos + slen]).decode("utf-8", "replace"))
            pos += slen
        elif code == b"R":
            (slen,) = struct.unpack_from("<I", buf, pos)
            pos += 4
            props.append(bytes(buf[pos:pos + slen]))
            pos += slen
        else:
            raise ValueError(f"unknown FBX property code {code!r}")
    return props, pos


def _read_node(data: bytes, pos: int, big: bool):
    """Returns (node or None, next position).  None = null sentinel."""
    if big:  # version >= 7500: 64-bit offsets, 25-byte sentinel
        end, n_props, prop_len = struct.unpack_from("<QQQ", data, pos)
        pos += 24
    else:
        end, n_props, prop_len = struct.unpack_from("<III", data, pos)
        pos += 12
    (name_len,) = struct.unpack_from("<B", data, pos)
    pos += 1
    if end == 0 and n_props == 0 and name_len == 0:
        return None, pos
    name = data[pos:pos + name_len].decode("utf-8", "replace")
    pos += name_len
    props, used = _read_props(memoryview(data)[pos:pos + prop_len], n_props)
    pos += prop_len
    node = FbxNode(name, props)
    while pos < end:
        child, pos = _read_node(data, pos, big)
        if child is None:
            break
        node.children.append(child)
    return node, end


def read_fbx(path: Path) -> list[FbxNode]:
    """Parse a binary FBX file into its top-level node list."""
    data = Path(path).read_bytes()
    if not data.startswith(_MAGIC[:21]):
        raise ValueError(f"{path} is not a binary FBX file")
    (version,) = struct.unpack_from("<I", data, 23)
    big = version >= 7500
    pos = 27
    nodes = []
    while pos < len(data):
        node, pos = _read_node(data, pos, big)
        if node is None:
            break
        nodes.append(node)
    return nodes


# ---------------------------------------------------------------------------
# mesh <-> document


def mesh_to_fbx_nodes(mesh: TriangleMesh) -> list[FbxNode]:
    """Build the minimal document tree for one mesh (mirrors the ASCII
    writer's layout in export/fbx.py)."""
    verts = np.asarray(mesh.vertices, np.float64).reshape(-1)
    tris = np.asarray(mesh.triangles, np.int64)
    poly = tris.astype(np.int32).copy()
    poly[:, 2] = -poly[:, 2] - 1  # FBX end-of-polygon encoding

    geom = FbxNode("Geometry", [1000, "Geometry::mesh", "Mesh"], [
        FbxNode("Vertices", [verts]),
        FbxNode("PolygonVertexIndex", [poly.reshape(-1)]),
        FbxNode("GeometryVersion", [124]),
    ])
    layers = []
    if mesh.vertex_normals is not None:
        normals = np.asarray(mesh.vertex_normals, np.float64)
        geom.children.append(FbxNode("LayerElementNormal", [0], [
            FbxNode("Version", [101]),
            FbxNode("Name", ["Normals"]),
            FbxNode("MappingInformationType", ["ByVertice"]),
            FbxNode("ReferenceInformationType", ["Direct"]),
            FbxNode("Normals", [normals.reshape(-1)]),
        ]))
        layers.append("LayerElementNormal")
    if mesh.vertex_colors is not None:
        colors = np.asarray(mesh.vertex_colors, np.float64)
        if colors.size and colors.max() > 1.0:
            colors = colors / 255.0
        rgba = np.concatenate(
            [colors, np.ones((len(colors), 1))], axis=1
        )
        geom.children.append(FbxNode("LayerElementColor", [0], [
            FbxNode("Version", [101]),
            FbxNode("Name", ["VertexColors"]),
            FbxNode("MappingInformationType", ["ByVertice"]),
            FbxNode("ReferenceInformationType", ["Direct"]),
            FbxNode("Colors", [rgba.reshape(-1)]),
        ]))
        layers.append("LayerElementColor")
    if layers:
        geom.children.append(FbxNode("Layer", [0], [
            FbxNode("Version", [100]),
        ] + [
            FbxNode("LayerElement", [], [
                FbxNode("Type", [t]),
                FbxNode("TypedIndex", [0]),
            ])
            for t in layers
        ]))

    return [
        FbxNode("FBXHeaderExtension", [], [
            FbxNode("FBXHeaderVersion", [1003]),
            FbxNode("FBXVersion", [7400]),
        ]),
        FbxNode("GlobalSettings", [], [FbxNode("Version", [1000])]),
        # Documents/References: the scene-root lookup path stock importers
        # (assimp FBXDocument, Blender) walk before touching Objects.
        FbxNode("Documents", [], [
            FbxNode("Count", [1]),
            FbxNode("Document", [3000, "", "Scene"], [
                FbxNode("RootNode", [0]),
            ]),
        ]),
        FbxNode("References", []),
        FbxNode("Definitions", [], [
            FbxNode("Version", [100]),
            FbxNode("Count", [2]),
            FbxNode("ObjectType", ["Geometry"], [FbxNode("Count", [1])]),
            FbxNode("ObjectType", ["Model"], [FbxNode("Count", [1])]),
        ]),
        FbxNode("Objects", [], [
            geom,
            FbxNode("Model", [2000, "Model::mesh", "Mesh"], [
                FbxNode("Version", [232]),
            ]),
        ]),
        FbxNode("Connections", [], [
            FbxNode("C", ["OO", 1000, 2000]),
            FbxNode("C", ["OO", 2000, 0]),
        ]),
    ]


def _per_vertex(values, n_verts, tris, corners, layer: FbxNode):
    """Resolve a layer element to per-vertex rows, honoring the mapping and
    reference modes that appear in the wild.  `corners` maps each triangle
    corner back to its position in PolygonVertexIndex, so ByPolygonVertex
    values stay aligned through fan-triangulation of >3-gons."""
    idx_node = None
    for cand in ("ColorIndex", "NormalsIndex", "UVIndex"):
        idx_node = layer.find(cand) or idx_node
    ref = layer.find("ReferenceInformationType")
    mapping = layer.find("MappingInformationType")
    ref = ref.props[0] if ref else "Direct"
    mapping = mapping.props[0] if mapping else "ByVertice"
    if ref == "IndexToDirect" and idx_node is not None:
        values = values[np.asarray(idx_node.props[0], np.int64)]
    if mapping in ("ByVertice", "ByVertex"):
        return values[:n_verts]
    if mapping == "ByPolygonVertex":
        out = np.zeros((n_verts, values.shape[1]), values.dtype)
        out[tris.reshape(-1)] = values[corners.reshape(-1)]
        return out
    return None


def fbx_nodes_to_mesh(nodes: list[FbxNode]) -> TriangleMesh:
    """Extract the first Geometry as a TriangleMesh (fan-triangulating
    any higher-order polygons)."""
    objects = next((n for n in nodes if n.name == "Objects"), None)
    if objects is None:
        raise ValueError("FBX file has no Objects section")
    geom = objects.find("Geometry")
    if geom is None:
        raise ValueError("FBX file has no Geometry object")
    verts = np.asarray(geom.find("Vertices").props[0], np.float64)
    verts = verts.reshape(-1, 3)
    pvi = np.asarray(geom.find("PolygonVertexIndex").props[0], np.int64)

    # Decode polygons: negative entry (-i - 1) ends a polygon; fan-split.
    # `corners` records each triangle corner's position in the original
    # PolygonVertexIndex stream (needed to realign ByPolygonVertex layers).
    tris = []
    corners = []
    start = 0
    ends = np.nonzero(pvi < 0)[0]
    for e in ends:
        poly = pvi[start:e + 1].copy()
        poly[-1] = -poly[-1] - 1
        for k in range(1, len(poly) - 1):
            tris.append((poly[0], poly[k], poly[k + 1]))
            corners.append((start, start + k, start + k + 1))
        start = e + 1
    tris = np.asarray(tris, np.int64).reshape(-1, 3)
    corners = np.asarray(corners, np.int64).reshape(-1, 3)

    mesh = TriangleMesh(verts, tris)
    col = geom.find("LayerElementColor")
    if col is not None and col.find("Colors") is not None:
        rgba = np.asarray(col.find("Colors").props[0], np.float64)
        rgba = rgba.reshape(-1, 4)
        rows = _per_vertex(rgba, len(verts), tris, corners, col)
        if rows is not None:
            mesh.vertex_colors = rows[:, :3]
    nrm = geom.find("LayerElementNormal")
    if nrm is not None and nrm.find("Normals") is not None:
        vals = np.asarray(nrm.find("Normals").props[0], np.float64)
        vals = vals.reshape(-1, 3)
        rows = _per_vertex(vals, len(verts), tris, corners, nrm)
        if rows is not None:
            mesh.vertex_normals = rows
    return mesh


def write_fbx_mesh(path: Path, mesh: TriangleMesh) -> None:
    write_fbx(path, mesh_to_fbx_nodes(mesh))


def read_fbx_mesh(path: Path) -> TriangleMesh:
    return fbx_nodes_to_mesh(read_fbx(path))
