"""Scoring steps (the eval half of the JAX package's runner)."""
