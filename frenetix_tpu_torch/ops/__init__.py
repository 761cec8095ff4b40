"""Batched numeric stages of the replanning cycle and the CUDA kernel wrappers."""
