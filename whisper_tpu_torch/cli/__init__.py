"""Command-line interface of the PyTorch port."""
