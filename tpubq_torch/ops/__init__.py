"""Kernels, linear algebra, integrals and the hand-written Hopper kernels."""
