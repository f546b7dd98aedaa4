"""Fills, tridiagonal solves and their CUDA kernels (K3, K4, K5, K6/K7); logsignatures."""
