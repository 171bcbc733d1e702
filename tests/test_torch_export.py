"""mq3d_tpu_torch's exports (FBX binary and ASCII, COLMAP, OBJ) against the
JAX package, on the CPU.

The same meshes and models, made from a seed with numpy, go through both
packages.  Tolerances: none.  FBX and COLMAP files must be equal byte for
byte, each package must read the other's files to the same arrays, and the
OBJ import must give equal vertices, triangles, UVs and colours.
"""

import numpy as np
import pytest
import torch

from mq3d_tpu.dataio.ply import TriangleMesh as JaxMesh
from mq3d_tpu.dataio.ply import write_ply_mesh as jax_write_ply_mesh
from mq3d_tpu.export import colmap as jax_colmap
from mq3d_tpu.export import fbx as jax_fbx
from mq3d_tpu.export import fbx_binary as jax_fbx_binary
from mq3d_tpu.export import obj as jax_obj
from mq3d_tpu_torch.dataio.ply import TriangleMesh
from mq3d_tpu_torch.export import colmap, fbx, fbx_binary, obj
from mq3d_tpu_torch.utils.png import imwrite

torch.set_num_threads(1)


def grid_mesh(rng, g: int = 40, colors: bool = True, normals: bool = False):
    """A noisy g x g height-field grid: 2 (g-1)^2 triangles, with a
    boundary; vertex colours in [0, 1] and unit normals when asked.
    Returns (JAX mesh, port mesh) over the same arrays."""
    x, y = np.meshgrid(np.linspace(0, 1, g), np.linspace(0, 1, g))
    z = 0.05 * rng.standard_normal((g, g))
    verts = np.stack([x, y, z], -1).reshape(-1, 3)
    idx = np.arange(g * g).reshape(g, g)
    a, b, c, d = idx[:-1, :-1], idx[:-1, 1:], idx[1:, :-1], idx[1:, 1:]
    tris = np.concatenate([np.stack([a, b, d], -1).reshape(-1, 3),
                           np.stack([a, d, c], -1).reshape(-1, 3)])
    col = rng.random((len(verts), 3)) if colors else None
    nrm = None
    if normals:
        nrm = rng.standard_normal((len(verts), 3))
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return (JaxMesh(verts, tris, vertex_colors=col, vertex_normals=nrm),
            TriangleMesh(verts.copy(), tris.copy(), vertex_colors=None if col is None
                         else col.copy(), vertex_normals=None if nrm is None else nrm.copy()))


MESH_KINDS = {"plain": {}, "colors": {"colors": True},
              "colors+normals": {"colors": True, "normals": True},
              "normals": {"normals": True}}


def _kind(name):
    kw = {"colors": False}
    kw.update(MESH_KINDS[name])
    return kw


@pytest.mark.parametrize("kind", list(MESH_KINDS))
def test_binary_fbx_bytes_equal(tmp_path, rng, kind):
    jm, pm = grid_mesh(rng, **_kind(kind))
    jax_fbx_binary.write_fbx_mesh(tmp_path / "jax.fbx", jm)
    fbx_binary.write_fbx_mesh(tmp_path / "port.fbx", pm)
    want = (tmp_path / "jax.fbx").read_bytes()
    assert len(want) > 10_000
    assert (tmp_path / "port.fbx").read_bytes() == want


@pytest.mark.parametrize("colors", [False, True], ids=["plain", "colors"])
def test_ascii_fbx_bytes_equal(tmp_path, rng, colors):
    jm, pm = grid_mesh(rng, g=12, colors=colors)
    jax_write_ply_mesh(tmp_path / "m.ply", jm)
    jax_fbx.convert_ply_to_fbx(tmp_path / "m.ply", tmp_path / "jax.fbx", ascii=True)
    fbx.convert_ply_to_fbx(tmp_path / "m.ply", tmp_path / "port.fbx", ascii=True)
    want = (tmp_path / "jax.fbx").read_text()
    assert want.startswith("; FBX 7.3.0") and ("Colors:" in want) == colors
    assert (tmp_path / "port.fbx").read_text() == want


@pytest.mark.parametrize("colors", [False, True], ids=["plain", "colors"])
def test_convert_ply_to_fbx_bytes_equal(tmp_path, rng, colors):
    """The PLY -> binary FBX conversion of --export-fbx (the JAX package's
    Aspose probe finds no package and takes the same native writer)."""
    jm, _ = grid_mesh(rng, colors=colors)
    jax_write_ply_mesh(tmp_path / "m.ply", jm)
    jax_fbx.convert_ply_to_fbx(tmp_path / "m.ply", tmp_path / "jax.fbx")
    fbx.convert_ply_to_fbx(tmp_path / "m.ply", tmp_path / "port.fbx")
    assert (tmp_path / "port.fbx").read_bytes() == (tmp_path / "jax.fbx").read_bytes()


def _assert_meshes_equal(a, b):
    np.testing.assert_array_equal(a.vertices, b.vertices)
    np.testing.assert_array_equal(a.triangles, b.triangles)
    for k in ("vertex_colors", "vertex_normals"):
        x, y = getattr(a, k), getattr(b, k)
        assert (x is None) == (y is None), k
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("kind", list(MESH_KINDS))
def test_each_package_reads_the_others_binary_fbx(tmp_path, rng, kind):
    jm, pm = grid_mesh(rng, **_kind(kind))
    jax_fbx_binary.write_fbx_mesh(tmp_path / "jax.fbx", jm)
    fbx_binary.write_fbx_mesh(tmp_path / "port.fbx", pm)
    by_port = fbx.read_fbx_mesh(tmp_path / "jax.fbx")
    by_jax = jax_fbx.read_fbx_mesh(tmp_path / "port.fbx")
    _assert_meshes_equal(by_port, by_jax)
    _assert_meshes_equal(by_port, fbx.read_fbx_mesh(tmp_path / "port.fbx"))
    np.testing.assert_array_equal(by_port.vertices, pm.vertices)
    np.testing.assert_array_equal(by_port.triangles, pm.triangles)


def test_each_package_reads_the_others_ascii_fbx(tmp_path, rng):
    jm, pm = grid_mesh(rng, g=12)
    jax_fbx._write_ascii_fbx(jm, tmp_path / "jax.fbx")
    fbx._write_ascii_fbx(pm, tmp_path / "port.fbx")
    _assert_meshes_equal(fbx.read_fbx_mesh(tmp_path / "jax.fbx"),
                         jax_fbx.read_fbx_mesh(tmp_path / "port.fbx"))


def test_fbx_node_tree_and_fbx_to_ply(tmp_path, rng):
    """The raw node reader and FBX -> PLY agree across the packages."""
    jm, pm = grid_mesh(rng, colors=True, normals=True)
    fbx_binary.write_fbx_mesh(tmp_path / "port.fbx", pm)

    def walk(nodes):
        return [(n.name, len(n.props), walk(n.children)) for n in nodes]

    assert walk(fbx_binary.read_fbx(tmp_path / "port.fbx")) == walk(
        jax_fbx_binary.read_fbx(tmp_path / "port.fbx"))
    jax_fbx.convert_fbx_to_ply(tmp_path / "port.fbx", tmp_path / "jax.ply")
    fbx.convert_fbx_to_ply(tmp_path / "port.fbx", tmp_path / "port.ply")
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()


def _model(pkg, rng):
    """A model with every record kind: two camera models, an image with
    2D points and a name with a space, points with and without tracks."""
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    xyz = rng.normal(size=(3, 3))
    cameras = {
        1: pkg.Camera(1, "PINHOLE", 640, 480, np.array([500.0, 500.5, 320.25, 240.0])),
        3: pkg.Camera(3, "OPENCV", 1280, 960, rng.normal(size=8)),
    }
    images = {
        1: pkg.Image(1, q, rng.normal(size=3), 1, "LEFT_123.png"),
        2: pkg.Image(2, np.array([1.0, 0, 0, 0]), np.zeros(3), 3, "name with space.png",
                     xys=rng.random((3, 2)), point3D_ids=np.array([7, 2, -1])),
    }
    points = {
        7: pkg.Point3D(7, xyz[0], np.array([255, 0, 10], np.uint8), 0.5,
                       np.array([1, 2]), np.array([0, 1])),
        2: pkg.Point3D(2, xyz[1], np.array([0, 128, 255], np.uint8)),
        9: pkg.Point3D(9, xyz[2], np.array([1, 2, 3], np.uint8), 0.25),
    }
    return cameras, images, points


@pytest.mark.parametrize("ext", [".bin", ".txt"])
def test_colmap_model_bytes_equal(tmp_path, ext):
    jax_colmap.write_model(*_model(jax_colmap, np.random.default_rng(5)), tmp_path / "jax",
                           ext=ext)
    colmap.write_model(*_model(colmap, np.random.default_rng(5)), tmp_path / "port", ext=ext)
    for name in ("cameras", "images", "points3D"):
        want = (tmp_path / "jax" / f"{name}{ext}").read_bytes()
        assert len(want) > 8
        assert (tmp_path / "port" / f"{name}{ext}").read_bytes() == want, name


def _assert_models_equal(a, b):
    (ca, ia, pa), (cb, ib, pb) = a, b
    assert ca.keys() == cb.keys() and ia.keys() == ib.keys() and pa.keys() == pb.keys()
    for k in ca:
        assert (ca[k].id, ca[k].model, ca[k].width, ca[k].height) == (
            cb[k].id, cb[k].model, cb[k].width, cb[k].height)
        np.testing.assert_array_equal(ca[k].params, cb[k].params)
    for k in ia:
        assert (ia[k].id, ia[k].camera_id, ia[k].name) == (ib[k].id, ib[k].camera_id,
                                                           ib[k].name)
        for f in ("qvec", "tvec", "xys", "point3D_ids"):
            np.testing.assert_array_equal(getattr(ia[k], f), getattr(ib[k], f), err_msg=f)
    for k in pa:
        assert pa[k].error == pb[k].error
        for f in ("xyz", "rgb", "image_ids", "point2D_idxs"):
            np.testing.assert_array_equal(getattr(pa[k], f), getattr(pb[k], f), err_msg=f)


@pytest.mark.parametrize("ext", [".bin", ".txt"])
def test_colmap_read_model_across_packages(tmp_path, ext):
    jax_colmap.write_model(*_model(jax_colmap, np.random.default_rng(6)), tmp_path / "jax",
                           ext=ext)
    colmap.write_model(*_model(colmap, np.random.default_rng(6)), tmp_path / "port", ext=ext)
    by_port = colmap.read_model(tmp_path / "jax")
    by_jax = jax_colmap.read_model(tmp_path / "port")
    _assert_models_equal(by_port, by_jax)
    _assert_models_equal(by_port, colmap.read_model(tmp_path / "port", ext=ext))


def test_colmap_quaternions_equal(rng):
    for _ in range(50):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        R = colmap.qvec2rotmat(q)
        np.testing.assert_array_equal(R, jax_colmap.qvec2rotmat(q))
        np.testing.assert_array_equal(colmap.rotmat2qvec(R), jax_colmap.rotmat2qvec(R))


@pytest.fixture()
def obj_project(tmp_path):
    """tests/test_obj_cli.py's OBJ + MTL + texture triple (the texture
    written with the port's PNG writer), plus an OBJ with negative indices,
    a pentagon, a face without UVs and no material."""
    tex = np.zeros((16, 16, 3), np.uint8)
    tex[:, :8] = (0, 0, 255)  # left half red (BGR)
    tex[:, 8:] = (255, 0, 0)  # right half blue
    imwrite(tmp_path / "tex.png", tex)
    (tmp_path / "mesh.mtl").write_text("newmtl mat0\nKd 0.5 0.5 0.5\nmap_Kd tex.png\n")
    (tmp_path / "mesh.obj").write_text(
        "mtllib mesh.mtl\n"
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
        "vt 0.1 0.5\nvt 0.9 0.5\nvt 0.9 0.5\nvt 0.1 0.5\n"
        "usemtl mat0\n"
        "f 1/1 2/2 3/3 4/4\n"
    )
    (tmp_path / "kd.mtl").write_text("newmtl flat\nKd 0.25 0.5 0.75\n")
    (tmp_path / "other.obj").write_text(
        "# comment\nmtllib kd.mtl\n"
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0.5 1.5 0\nv 2 2 2\n"
        "vt 0.0 0.0\nvt 1.0 1.0\n"
        "f 1/1 2/2 3/1 5/2 4/1\n"
        "f -1 -2 -3\n"
    )
    return tmp_path


@pytest.mark.parametrize("name", ["mesh.obj", "other.obj"])
def test_obj_import_equal(obj_project, name):
    path = obj_project / name
    jm, juv, jmtl = jax_obj.load_obj(path)
    pm, puv, pmtl = obj.load_obj(path)
    assert pmtl == jmtl
    np.testing.assert_array_equal(pm.vertices, jm.vertices)
    np.testing.assert_array_equal(pm.triangles, jm.triangles)
    assert (puv is None) == (juv is None)
    if juv is not None:
        np.testing.assert_array_equal(puv, juv)
    assert obj.parse_mtl(obj_project / jmtl) == jax_obj.parse_mtl(obj_project / jmtl)
    jc = jax_obj.convert_obj_to_mesh(path).vertex_colors
    pc = obj.convert_obj_to_mesh(path).vertex_colors
    assert jc is not None
    np.testing.assert_array_equal(pc, jc)
