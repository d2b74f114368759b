"""Tensor ops of the port: transform, packers, IDCT, colour."""
