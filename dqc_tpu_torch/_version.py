"""Version of the PyTorch/CUDA port (kept equal to the JAX package's)."""
__version__ = "0.1.0"
