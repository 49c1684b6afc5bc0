"""IO: image output (single images and feedback grids) and checkpoints."""

from .image import adjust_dynamic_range, save_image_grid, save_single_image

__all__ = ["adjust_dynamic_range", "save_image_grid", "save_single_image"]
