"""ops tier of the PyTorch port."""
