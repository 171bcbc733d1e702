"""Shared argument handling of the port's step CLIs."""

from __future__ import annotations

import argparse
from pathlib import Path

DEFAULT_CONFIG = Path(__file__).resolve().parents[2] / "config/pipeline_config.yml"


def step_parser(description: str) -> argparse.ArgumentParser:
    """--project_dir, --config (default config/pipeline_config.yml) and
    --device (default cuda), the arguments of every pipeline step CLI."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--project_dir", type=Path, required=True,
                        help="capture project directory")
    parser.add_argument("--config", type=Path, default=DEFAULT_CONFIG)
    add_device(parser)
    return parser


def add_device(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")


def step_processor(description: str, argv=None):
    """Parse a step CLI's arguments and return its PipelineProcessor."""
    from mq3d_tpu_torch.pipeline.processor import PipelineProcessor

    args = step_parser(description).parse_args(argv)
    return PipelineProcessor(project_dir=args.project_dir, config=args.config,
                             device=args.device)
