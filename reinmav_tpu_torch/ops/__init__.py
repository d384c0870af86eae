from . import quadmath

__all__ = ["quadmath"]
