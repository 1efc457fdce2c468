"""container tier of the PyTorch port."""
