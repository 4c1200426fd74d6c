"""Training data: datasets, the loader, the RealESRGAN degradation."""
