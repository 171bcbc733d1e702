"""Reconstruction steps 4-6 of mq3d_tpu_torch on the card against the same
code on the CPU.

Marked `cuda`: they skip without an NVIDIA GPU.  This file imports neither
jax nor mq3d_tpu, so it runs on a machine with the card and no JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda_colored.py

One volume (the port's synthetic box room, integrated on the CPU) is moved
to the card.  Tolerances: marching cubes, component labels and the raycast
scene tables are identical (integer ops and elementwise IEEE float32);
rendered depth identical on >= 99.9 % of the pixels with |dz| <= 1e-4 m
elsewhere (the port's parity bound with the JAX package); the Gauss-Newton
H and b (float64 sums in another order) within 1e-9 relative.
"""

import numpy as np
import pytest
import torch

from mq3d_tpu_torch.dataio.data_io import DataIO
from mq3d_tpu_torch.models.side import Side
from mq3d_tpu_torch.models.transforms import CoordinateSystem
from mq3d_tpu_torch.ops import mesh_filter, raycast
from mq3d_tpu_torch.ops.tsdf import TSDFConfig, TSDFVolume, state_from_numpy, state_to_numpy
from mq3d_tpu_torch.recon import color_opt
from mq3d_tpu_torch.testing.synthetic import SyntheticSceneConfig, write_synthetic_project

CFG = dict(voxel_size=0.02, block_resolution=16, block_count=4096, grid_dim=16,
           depth_max=4.0, trunc_voxel_multiplier=4.0, chunk_active_capacity=4096,
           integrate_tile=256)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    d = tmp_path_factory.mktemp("cuda_colored")
    write_synthetic_project(d, SyntheticSceneConfig(n_frames=12))
    io = DataIO(d)
    ds = io.depth.load_depth_dataset(Side.LEFT, use_cache=False)
    ds.transforms = ds.transforms.convert_coordinate_system(CoordinateSystem.OPEN3D,
                                                            is_camera=True)
    depth, valid = io.depth.load_depth_stack(Side.LEFT, ds)
    K = ds.get_render_intrinsic_matrices().astype(np.float32)
    T = ds.transforms.extrinsics_wc.astype(np.float32)
    cfg = TSDFConfig(**CFG)
    cpu = TSDFVolume(cfg, device="cpu")
    cpu.integrate(depth, K, T, valid)
    card = TSDFVolume(cfg, state_from_numpy(cfg, state_to_numpy(cpu.state), "cuda"))
    return cpu, card, K, T, (int(ds.widths[0]), int(ds.heights[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("wt", [0.5, 1.5])
def test_marching_cubes_card_equals_cpu(scene, wt):
    cpu, card, *_ = scene
    a, b = cpu.extract_triangle_mesh(wt), card.extract_triangle_mesh(wt)
    assert len(a.triangles) > 1000
    for k in ("vertices", "triangles", "vertex_normals"):
        np.testing.assert_array_equal(getattr(b, k), getattr(a, k), err_msg=k)


@pytest.mark.cuda
def test_component_labels_card_equal_cpu(scene):
    cpu, *_ = scene
    mesh = cpu.extract_triangle_mesh(0.5)
    a = mesh_filter.cluster_connected_triangles(mesh, device="cpu")
    b = mesh_filter.cluster_connected_triangles(mesh, device="cuda")
    for x, y in zip(a, b):
        np.testing.assert_array_equal(y, x)


@pytest.mark.cuda
def test_raycast_card_matches_cpu(scene):
    cpu, card, K, T, (w, h) = scene
    for x, y in zip(raycast.prepare_scene(cpu.cfg, cpu.state, 1024),
                    raycast.prepare_scene(card.cfg, card.state, 1024)):
        assert torch.equal(y.cpu(), x)
    a = raycast.raycast_depth_batch(cpu, K[:4], T[:4], w, h)
    b = raycast.raycast_depth_batch(card, K[:4], T[:4], w, h)
    fa, fb = np.isfinite(a), np.isfinite(b)
    assert fa.mean() > 0.5 and (fa == fb).mean() >= 0.999
    both = fa & fb
    assert (a[both] == b[both]).mean() >= 0.999
    assert np.abs(a[both] - b[both]).max() <= 1e-4


@pytest.mark.cuda
def test_gn_terms_card_match_cpu(scene):
    cpu, _, K, T, (w, h) = scene
    verts = cpu.extract_triangle_mesh(1.5).vertices.astype(np.float32)
    rng = np.random.default_rng(0)
    F = 3
    args = [verts, K[:F], T[:F], rng.random((F, h, w), dtype=np.float32),
            rng.standard_normal((F, h, w), dtype=np.float32),
            rng.standard_normal((F, h, w), dtype=np.float32),
            rng.random(len(verts), dtype=np.float32)]
    depth = raycast.raycast_depth_batch(cpu, K[:F], T[:F], w, h)
    out = {}
    for dev in ("cpu", "cuda"):
        t = [torch.from_numpy(np.array(a)).to(dev) for a in args]
        vis = color_opt._visibility(t[0], t[1], t[2], torch.from_numpy(depth).to(dev))
        out[dev] = [x.cpu().numpy() for x in color_opt._gn_terms(*t, vis)]
    (H, b, res, n), (H2, b2, res2, n2) = out["cpu"], out["cuda"]
    assert (n > 100).all() and np.array_equal(n, n2)
    assert np.abs(H2 - H).max() <= 1e-9 * np.abs(H).max()
    assert np.abs(b2 - b).max() <= 1e-9 * np.abs(b).max()
    np.testing.assert_allclose(res2, res, rtol=1e-5)
