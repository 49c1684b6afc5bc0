"""IO: image output."""

from .image import adjust_dynamic_range, save_single_image

__all__ = ["adjust_dynamic_range", "save_single_image"]
