from . import dstd

__all__ = ["dstd"]
