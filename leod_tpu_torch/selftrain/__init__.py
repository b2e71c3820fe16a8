"""Self-training of the PyTorch port: pseudo-labels, the tracker filter,
online SSOD."""
