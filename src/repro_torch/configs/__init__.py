"""Model configurations of the PyTorch port."""
