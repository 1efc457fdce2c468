"""utils tier of the PyTorch port."""
