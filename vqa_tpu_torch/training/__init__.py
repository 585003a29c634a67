"""Training of the port: the trainer (``train``) and checkpoints
(``checkpoint``)."""
