"""Tensor ops of the port: plain PyTorch versions beside the hand-written
Hopper kernels (ops/kernels, csrc/)."""
