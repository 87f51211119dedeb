"""The port's optimizer (``adamw``)."""
