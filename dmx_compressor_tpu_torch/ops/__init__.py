"""Ops: packed BFP, caches, attention and the three CUDA kernel wrappers."""
