"""parallel of the PyTorch port."""
