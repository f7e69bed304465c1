"""Datasets of the port."""
