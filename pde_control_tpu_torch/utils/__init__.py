"""Utilities: weight conversion from the JAX package."""
