"""cuda tier of the PyTorch port."""
