"""Core: the paper's contribution (ZERO-resizing, plans, the controller)."""
