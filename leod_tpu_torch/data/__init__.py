"""Host-side data of the PyTorch port: labels, sequences, loaders."""
