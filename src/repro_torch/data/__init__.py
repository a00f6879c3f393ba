from . import pointclouds

__all__ = ["pointclouds"]
