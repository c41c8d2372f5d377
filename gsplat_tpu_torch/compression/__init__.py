from .png_compression import PngCompression

__all__ = ["PngCompression"]
