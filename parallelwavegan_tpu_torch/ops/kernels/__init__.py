"""Hand-written CUDA kernels for Hopper (sm_90a) with their plain versions."""
