"""Convolution layers and residual blocks of the port."""
