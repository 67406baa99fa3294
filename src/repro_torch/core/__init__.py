"""Core of the PyTorch port: bucket specs, the flat multisplit pipeline and
the radix sort built on it."""
