"""Synthetic LM data for ``launch.train``."""
