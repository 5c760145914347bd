"""Data of the port: the synthetic per-worker samplers (numpy)."""

from .synthetic import class_gaussian_images, make_token_sampler

__all__ = ["class_gaussian_images", "make_token_sampler"]
