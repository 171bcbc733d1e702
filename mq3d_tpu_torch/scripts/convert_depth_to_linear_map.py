"""CLI: raw NDC depth -> linear depth PNGs of one capture.

    python -m mq3d_tpu_torch.scripts.convert_depth_to_linear_map \
        --project_dir <capture dir> [--config <pipeline yml>] [--device cpu]

Counterpart of scripts/convert_depth_to_linear_map.py of the JAX build
(host numpy; --device is accepted for a uniform surface).
"""

from __future__ import annotations

from mq3d_tpu_torch.scripts._cli import step_processor


def main(argv=None):
    step_processor("Convert raw depth to linear PNGs", argv).convert_depth_to_linear()


if __name__ == "__main__":
    main()
