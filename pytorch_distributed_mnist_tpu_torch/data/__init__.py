"""Data layer of the port: MNIST IDX IO, normalize, synthetic data."""
