"""Layers, the GRU recurrence and spatial attention (kernels in csrc/)."""
