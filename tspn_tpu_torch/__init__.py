"""PyTorch / CUDA port of tspn_tpu for one NVIDIA H100 (see README, "The PyTorch port")."""

__version__ = "0.1.0"
