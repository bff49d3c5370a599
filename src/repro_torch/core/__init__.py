"""Rule, engine and network layers of the PyTorch port."""
