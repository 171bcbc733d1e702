"""CLI: scene reconstruction of one capture (steps 0-6 as the config
switches them; K1 on the card).

    python -m mq3d_tpu_torch.scripts.reconstruct_scene \
        --project_dir <capture dir> [--config <pipeline yml>] [--device cpu]

Counterpart of scripts/reconstruct_scene.py of the JAX build; needs the RGB
frames of convert_yuv_to_rgb.
"""

from __future__ import annotations

from mq3d_tpu_torch.scripts._cli import step_processor


def main(argv=None):
    step_processor("Reconstruct a 3D scene from a capture", argv).reconstruct_scene()


if __name__ == "__main__":
    main()
