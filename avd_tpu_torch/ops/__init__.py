"""Tensor ops of the port: resize, band matmuls, hashing, flow, features."""
