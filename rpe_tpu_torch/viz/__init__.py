"""Visualization: 3D trajectory HTML + annotated video (host side)."""

from .visualizer import Visualizer

__all__ = ["Visualizer"]
