"""Physical images."""

from .coordinatesystem import CoordinateSystem
from .image import Image, OpticalImage, ScalarImage

__all__ = ["CoordinateSystem", "Image", "OpticalImage", "ScalarImage"]
