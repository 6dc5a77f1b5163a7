"""Command-line drivers of the PyTorch port."""
