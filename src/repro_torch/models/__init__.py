"""Models: the dense decoder-only LM (``lm``)."""
