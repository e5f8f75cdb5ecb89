"""Host-side configuration of the PyTorch port."""
