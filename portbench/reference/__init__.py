"""The plain reference: extraction, IGMC and Adam in NumPy and plain
PyTorch. It imports nothing of igmc_torch, igmc_tpu or jax."""
