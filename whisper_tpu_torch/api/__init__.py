"""Model/Context/result API of the PyTorch port."""
