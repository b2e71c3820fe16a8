"""Detection metrics of the PyTorch port (Prophesee protocol, COCO AP)."""
