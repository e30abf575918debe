"""The plain reference that decides ``correct``: numpy and torch only,
nothing of the port or of the JAX package."""
