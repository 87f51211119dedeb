"""Drivers: the continuous-batching serve engine (``serve``)."""
