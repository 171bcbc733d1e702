"""The shipped configuration's pose optimisation on the bare box room, in
the JAX package and in mq3d_tpu_torch, on the CPU.

    JAX_PLATFORMS=cpu python tests/box_room_poses.py [--frames 200] [--width 80]

Not a test (it takes about ten minutes): it shows that the scene ICP of
config/pipeline_config.yml lets the second half-room fragment slide along
the room's parallel walls in both packages alike.  Each package gets the
same synthetic capture (the JAX package's writer, depth of --width x
0.8 --width pixels), runs steps 0-3 with the colour steps off, and the
optimized depth poses are compared with the ground truth; the script
prints each fragment's mean position error and the largest one.
"""

import argparse
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch
import yaml

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from mq3d_tpu.dataio.data_io import DataIO as JaxDataIO  # noqa: E402
from mq3d_tpu.models.side import Side as JaxSide  # noqa: E402
from mq3d_tpu.pipeline.processor import PipelineProcessor as JaxProcessor  # noqa: E402
from mq3d_tpu.testing.synthetic import (  # noqa: E402
    SyntheticSceneConfig,
    orbit_poses_o3d,
    write_synthetic_project,
)
from mq3d_tpu_torch.dataio.data_io import DataIO  # noqa: E402
from mq3d_tpu_torch.models.side import Side  # noqa: E402
from mq3d_tpu_torch.pipeline.processor import run_full_pipeline  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--width", type=int, default=80)
    args = ap.parse_args()
    torch.set_num_threads(4)
    root = Path(tempfile.mkdtemp())
    try:
        cfg = yaml.safe_load((REPO / "config/pipeline_config.yml").read_text())
        cfg["reconstruction"].update(optimize_color_pose=False,
                                     render_color_aligned_depth=False, device="cpu")
        path = root / "config.yml"
        path.write_text(yaml.safe_dump(cfg))
        scene = SyntheticSceneConfig(n_frames=args.frames, depth_width=args.width,
                                     depth_height=args.width * 4 // 5)
        write_synthetic_project(root / "jax", scene)
        shutil.copytree(root / "jax", root / "port")
        JaxProcessor(project_dir=root / "jax", config_yml_path=path).run_full_pipeline()
        run_full_pipeline(root / "port", path, device="cpu")
        gt = orbit_poses_o3d(scene).extrinsics_cw
        size = cfg["reconstruction"]["fragment_generation"]["fragment_size"]
        for name, load in (
                ("jax", lambda s: JaxDataIO(root / "jax").depth.load_optimized_depth_dataset(
                    JaxSide[s])),
                ("port", lambda s: DataIO(root / "port").depth.load_optimized_depth_dataset(
                    Side[s]))):
            for side in ("LEFT", "RIGHT"):
                d = load(side).transforms.extrinsics_cw[:, :3, 3] - gt[:, :3, 3]
                means = [d[i:i + size].mean(0).round(5).tolist()
                         for i in range(0, len(d), size)]
                print(f"{name} {side}: fragment mean position errors (m) {means}, "
                      f"largest {np.linalg.norm(d, axis=1).max():.5f} m")
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
