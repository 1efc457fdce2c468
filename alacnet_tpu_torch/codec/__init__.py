"""codec tier of the PyTorch port."""
