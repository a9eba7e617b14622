"""Flux differencing and the kernels' wrappers with their plain versions
(K1-K5, K7, K8, row 10)."""
