"""Tensor ops (NHWC at the public boundary) and the kernel wrappers."""
