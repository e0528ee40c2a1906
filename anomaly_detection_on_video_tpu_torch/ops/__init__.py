"""Preprocessing ops, metrics and the hand-written CUDA kernels (``kernels``)."""
