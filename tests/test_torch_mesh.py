"""mq3d_tpu_torch marching cubes, mesh filter and point sampling against
the JAX package, on the CPU.

Both packages work on the *same* volume: the JAX package integrates the
synthetic box room (tests/test_tsdf.py:15-25 config at 5 cm, and a 2 cm
variant with more blocks than one 128-block tile), and its state moves into
the port through `state_from_numpy`.  Tolerances:

- marching cubes (device paths): the raw buffers (vertex positions, resolved
  triangle indices, counts) and the final mesh (vertices, triangles,
  normals) are equal bit for bit; the interpolation has no fused
  multiply-add under XLA ((g + frac) * voxel), so none is needed;
- the numpy host paths are equal bit for bit;
- component labels equal up to relabelling (and equal to scipy's), and
  `filter_mesh_components` output identical;
- `sample_points_uniformly`: points, colours and normals identical.
"""

import numpy as np
import pytest
import torch

from mq3d_tpu.dataio.data_io import DataIO as JaxDataIO
from mq3d_tpu.dataio.ply import TriangleMesh as JaxMesh
from mq3d_tpu.dataio.ply import read_ply as jax_read_ply
from mq3d_tpu.dataio.ply import write_ply_mesh as jax_write_ply_mesh
from mq3d_tpu.models.side import Side as JaxSide
from mq3d_tpu.models.transforms import CoordinateSystem as JaxCS
from mq3d_tpu.ops import mc_tables as jax_mc
from mq3d_tpu.ops import mesh_filter as jax_mf
from mq3d_tpu.ops.sampling import sample_points_uniformly as jax_sample
from mq3d_tpu.ops.tsdf import TSDFConfig as JaxConfig
from mq3d_tpu.ops.tsdf import TSDFVolume as JaxVolume
from mq3d_tpu.ops.tsdf import _extract_mesh_jit
from mq3d_tpu.testing.synthetic import SyntheticSceneConfig, write_synthetic_project
from mq3d_tpu_torch.dataio.ply import TriangleMesh, read_ply, write_ply_mesh
from mq3d_tpu_torch.ops import mc_tables, mesh_filter
from mq3d_tpu_torch.ops.sampling import sample_points_uniformly
from mq3d_tpu_torch.ops.tsdf import TSDFConfig, TSDFVolume, _extract_mesh, state_from_numpy

torch.set_num_threads(1)

BASE = dict(voxel_size=0.05, block_resolution=16, block_count=2048, grid_dim=16,
            depth_max=4.0, trunc_voxel_multiplier=4.0, alloc_pixel_stride=2,
            chunk_active_capacity=2048, integrate_tile=256)
FINE = dict(BASE, voxel_size=0.02, block_count=4096, chunk_active_capacity=4096)


@pytest.fixture(scope="module")
def depth_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_mesh_proj")
    write_synthetic_project(d, SyntheticSceneConfig(n_frames=12))
    io = JaxDataIO(d)
    ds = io.depth.load_depth_dataset(JaxSide.LEFT, use_cache=False)
    ds.transforms = ds.transforms.convert_coordinate_system(JaxCS.OPEN3D, is_camera=True)
    depth, valid = io.depth.load_depth_stack(JaxSide.LEFT, ds)
    return depth, ds.get_render_intrinsic_matrices(), ds.transforms.extrinsics_wc, valid


def _volumes(depth_data, kw):
    depth, K, T, valid = depth_data
    jv = JaxVolume(JaxConfig(**kw))
    jv.integrate(depth, K, T, valid)
    state = {k: np.array(v) for k, v in jv.state._asdict().items()}
    cfg = TSDFConfig(**kw)
    return jv, TSDFVolume(cfg, state_from_numpy(cfg, state, "cpu"))


@pytest.fixture(scope="module", params=[BASE, FINE], ids=["voxel5cm", "voxel2cm"])
def volumes(request, depth_data):
    return _volumes(depth_data, request.param)


def assert_same_mesh(a, b, colors=False):
    for k in ("vertices", "triangles", "vertex_normals") + (("vertex_colors",) if colors else ()):
        x, y = getattr(a, k), getattr(b, k)
        assert x.shape == y.shape, k
        np.testing.assert_array_equal(y, x, err_msg=k)


def test_mc_tables_match_jax():
    for x, y in zip(jax_mc.build_tables(), mc_tables.build_tables()):
        np.testing.assert_array_equal(y, x)
    np.testing.assert_array_equal(mc_tables.edge_owner(), jax_mc.edge_owner())
    np.testing.assert_array_equal(mc_tables.CORNERS, jax_mc.CORNERS)
    np.testing.assert_array_equal(mc_tables.EDGES, jax_mc.EDGES)


@pytest.mark.parametrize("wt", [0.5, 1.5])
def test_extract_mesh_buffers_match_jax(volumes, wt):
    """The raw device outputs: vertex buffer, resolved triangle indices and
    counts, at capacities the mesh fits in."""
    jv, tv = volumes
    n_bucket = 128
    while n_bucket < tv.n_active:
        n_bucket *= 2
    max_verts, max_tris = 1 << 18, 1 << 19
    jverts, jtri, jnv, jnt = _extract_mesh_jit(
        jv.cfg, jv.state, np.float32(wt), n_bucket, max_verts, max_tris)
    verts, tri, nv, nt = _extract_mesh(tv.cfg, tv.state, wt, n_bucket, max_verts, max_tris)
    assert int(nv) == int(jnv) > 0 and int(nt) == int(jnt) > 0
    assert int(nv) <= max_verts and int(nt) <= max_tris
    np.testing.assert_array_equal(verts.numpy(), np.asarray(jverts))
    np.testing.assert_array_equal(tri.numpy(), np.asarray(jtri))


@pytest.mark.parametrize("wt", [0.5, 1.5])
def test_triangle_mesh_matches_jax(volumes, wt):
    jv, tv = volumes
    jm = jv.extract_triangle_mesh(weight_threshold=wt)
    tm = tv.extract_triangle_mesh(weight_threshold=wt)
    assert len(tm.triangles) > 300
    assert_same_mesh(jm, tm)
    # The numpy host path, the parity oracle of both packages.
    assert_same_mesh(jv.extract_triangle_mesh(wt, device=False),
                     tv.extract_triangle_mesh(wt, device=False))


def test_capacity_retry_and_truncation_match_jax(volumes, capsys):
    """A vertex ceiling below the mesh size: the first pass overflows, the
    retry reaches the ceiling, the result is truncated with a warning."""
    jv, tv = volumes
    jm = jv.extract_triangle_mesh(0.5, max_verts=6000, max_tris=9000)
    tm = tv.extract_triangle_mesh(0.5, max_verts=6000, max_tris=9000)
    assert "truncated" in capsys.readouterr().out
    assert 0 < len(tm.triangles) <= 9000
    assert_same_mesh(jm, tm)


def test_empty_and_partial_tile():
    """An empty volume gives an empty mesh; a volume with 129 blocks (one
    block past a 128-block tile) meshes every block, as the host path does."""
    cfg = TSDFConfig(**BASE)
    assert len(TSDFVolume(cfg, device="cpu").extract_triangle_mesh().vertices) == 0
    R, G, n = 16, 16, 129
    idx = np.arange(n)
    coords = np.stack([idx % G - 8, (idx // G) % G - 8, (idx // (G * G)) % G - 8],
                      -1).astype(np.int32)
    x = np.arange(R ** 3) // (R * R)
    tsdf = np.tile(((x - 7.5) / 8.0).astype(np.float32), (n, 1))
    vol = TSDFVolume._from_blocks(
        TSDFConfig(voxel_size=0.05, block_resolution=R, block_count=n, grid_dim=G),
        coords, tsdf, np.full((n, R ** 3), 5.0, np.float32), "cpu")
    dev = vol.extract_triangle_mesh(1.5)
    host = vol.extract_triangle_mesh(1.5, device=False)
    assert len(dev.vertices) == len(host.vertices) > 0
    assert len(dev.triangles) == len(host.triangles)


def test_state_version_tracks_changes(depth_data):
    depth, K, T, valid = depth_data
    tv = TSDFVolume(TSDFConfig(**BASE), device="cpu")
    v0 = tv._state_version
    tv.integrate(depth[:2], K[:2], T[:2], valid[:2])
    v1 = tv._state_version
    tv.reset()
    assert v0 < v1 < tv._state_version


def test_component_labels_match_jax(volumes):
    jv, tv = volumes
    mesh = tv.extract_triangle_mesh(0.5)
    labels, counts = mesh_filter.cluster_connected_triangles(mesh, device="cpu")
    jmesh = JaxMesh(mesh.vertices, mesh.triangles)
    jlabels, jcounts = jax_mf.cluster_connected_triangles(jmesh, device=True)
    hlabels, hcounts = mesh_filter.cluster_connected_triangles_host(mesh)
    assert len(counts) > 1  # the room's wall fragments are several components
    for other_l, other_c in ((jlabels, jcounts), (hlabels, hcounts)):
        np.testing.assert_array_equal(np.sort(counts), np.sort(other_c))
        pairs = np.unique(np.stack([labels, other_l], -1), axis=0)
        assert len(pairs) == len(counts)  # a bijection between labelings
    # Both number clusters by their least vertex, so even the ids agree.
    np.testing.assert_array_equal(labels, jlabels)


@pytest.mark.parametrize("min_tris", [5, 100, 10 ** 9], ids=["keep-most", "keep-some",
                                                            "keep-largest"])
def test_filter_mesh_components_matches_jax(volumes, min_tris):
    jv, tv = volumes
    mesh = tv.extract_triangle_mesh(0.5)
    mesh.vertex_colors = np.random.default_rng(0).random(mesh.vertices.shape)
    jmesh = JaxMesh(mesh.vertices, mesh.triangles, vertex_normals=mesh.vertex_normals,
                    vertex_colors=mesh.vertex_colors)
    out = mesh_filter.filter_mesh_components(mesh, min_triangle_count=min_tris, device="cpu")
    want = jax_mf.filter_mesh_components(jmesh, min_triangle_count=min_tris)
    assert 0 < len(out.triangles) <= len(mesh.triangles)
    assert_same_mesh(want, out, colors=True)


def test_second_filter_pass_can_change_the_mesh():
    """Why step 4 filters the baked mesh again: vertices 0 and 3 share a
    position, so the first pass keeps both triangles (distinct index
    triples) and its vertex merge then makes them duplicates; only a
    second pass drops one.  Both packages do the same."""
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 0], [1, 1, 0]], float)
    tris = np.array([[0, 1, 2], [3, 1, 2], [1, 4, 2]])
    once = mesh_filter.filter_mesh_components(TriangleMesh(verts, tris), 1, device="cpu")
    twice = mesh_filter.filter_mesh_components(once, 1, device="cpu")
    jonce = jax_mf.filter_mesh_components(JaxMesh(verts, tris), min_triangle_count=1)
    jtwice = jax_mf.filter_mesh_components(jonce, min_triangle_count=1)
    assert len(once.triangles) == 3 and len(twice.triangles) == 2
    for want, got in ((jonce, once), (jtwice, twice)):
        np.testing.assert_array_equal(got.vertices, want.vertices)
        np.testing.assert_array_equal(got.triangles, want.triangles)


def test_labels_converge_on_long_chain():
    """A strip of triangles whose vertex ids run against the chain: plain
    label propagation would need O(n) rounds, hook + compress O(log n)."""
    n = 4000
    v = np.arange(n + 2)[::-1]
    tris = np.stack([v[:-2], v[1:-1], v[2:]], -1)
    mesh = TriangleMesh(np.zeros((n + 2, 3)), tris)
    labels, counts = mesh_filter.cluster_connected_triangles(mesh, device="cpu")
    assert counts.tolist() == [n] and (labels == 0).all()


@pytest.mark.parametrize("with_attrs", [True, False])
def test_sampling_matches_jax(volumes, with_attrs):
    _, tv = volumes
    mesh = tv.extract_triangle_mesh(0.5)
    if with_attrs:
        mesh.vertex_colors = np.random.default_rng(1).random(mesh.vertices.shape)
    else:
        mesh.vertex_normals = None
    jmesh = JaxMesh(mesh.vertices, mesh.triangles, vertex_normals=mesh.vertex_normals,
                    vertex_colors=mesh.vertex_colors)
    for n, seed in ((5000, 0), (777, 3)):
        got = sample_points_uniformly(mesh, n, seed=seed)
        want = jax_sample(jmesh, n, seed=seed)
        for k in ("points", "colors", "normals"):
            x, y = getattr(want, k), getattr(got, k)
            assert (x is None) == (y is None), k
            if x is not None:
                np.testing.assert_array_equal(y, x, err_msg=k)
    assert len(sample_points_uniformly(mesh, 0).points) == 0


def test_each_package_reads_the_others_mesh(volumes, tmp_path):
    _, tv = volumes
    mesh = tv.extract_triangle_mesh(0.5)
    mesh.vertex_colors = np.random.default_rng(2).random(mesh.vertices.shape)
    write_ply_mesh(tmp_path / "port.ply", mesh)
    jax_write_ply_mesh(tmp_path / "jax.ply", JaxMesh(
        mesh.vertices, mesh.triangles, vertex_normals=mesh.vertex_normals,
        vertex_colors=mesh.vertex_colors))
    a, b = jax_read_ply(tmp_path / "port.ply"), read_ply(tmp_path / "jax.ply")
    for k in ("vertices", "triangles", "vertex_normals", "vertex_colors"):
        np.testing.assert_array_equal(getattr(b, k), getattr(a, k), err_msg=k)
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
