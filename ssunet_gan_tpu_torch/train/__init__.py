"""Supervised training of the port (the JAX package's train/)."""
