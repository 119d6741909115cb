"""Declarative preprocessing and the hand-written tree kernels."""
