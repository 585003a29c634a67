"""The inference engine of the port."""
