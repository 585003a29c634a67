"""Host preprocessing and the answer vocabulary of the port."""
