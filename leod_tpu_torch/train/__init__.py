"""Steps and loops of the PyTorch port (streaming evaluation)."""
