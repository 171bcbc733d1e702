"""Stereo side enum (reference: scripts/models/side.py:4)."""

from enum import Enum


class Side(Enum):
    LEFT = "left"
    RIGHT = "right"
