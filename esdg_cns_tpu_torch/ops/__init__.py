"""Flux differencing and the fused hex kernels (K1 volume, K2 surface)."""
