"""The plain reference the benchmark holds the port's outputs against:
NumPy and torch only, nothing of the port or of JAX."""
