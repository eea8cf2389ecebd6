"""Audio file decode for the PyTorch port."""
