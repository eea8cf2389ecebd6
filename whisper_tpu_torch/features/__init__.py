"""Log-mel front-end of the PyTorch port."""
