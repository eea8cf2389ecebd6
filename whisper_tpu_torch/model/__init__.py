"""Parameters, layers, encoder and decoder of the PyTorch port."""
