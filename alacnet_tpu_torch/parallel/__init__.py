"""parallel tier of the PyTorch port."""
