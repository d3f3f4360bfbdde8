"""Weight transfer from the JAX package."""
