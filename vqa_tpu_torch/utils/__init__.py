"""Configuration and tokenizer of the port (copies of the JAX package's)."""
