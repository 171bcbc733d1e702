"""CLI: YUV -> RGB conversion of one capture (K2 on the card).

    python -m mq3d_tpu_torch.scripts.convert_yuv_to_rgb \
        --project_dir <capture dir> [--config <pipeline yml>] [--device cpu]

Counterpart of scripts/convert_yuv_to_rgb.py of the JAX build: converts
the frames that have no RGB PNG yet.
"""

from __future__ import annotations

from mq3d_tpu_torch.scripts._cli import step_processor


def main(argv=None):
    step_processor("Convert raw YUV frames to RGB PNGs", argv).convert_yuv_to_rgb()


if __name__ == "__main__":
    main()
