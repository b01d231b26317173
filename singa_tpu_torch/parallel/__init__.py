"""Transformer layers in the JAX package's tensor-parallel shapes (serial
path only so far)."""
