"""Measurement scripts of the port, run on an NVIDIA GPU; the roofline
(``tools/roofline.py``) only counts, on any host."""
