"""Feature extraction and kernels of the port."""
