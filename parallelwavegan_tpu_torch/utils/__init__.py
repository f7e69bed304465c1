"""Config, IO, checkpoint and model-loading utilities of the port."""
