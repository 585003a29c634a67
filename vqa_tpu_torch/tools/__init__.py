"""Measurement scripts of the port, run on an NVIDIA GPU."""
