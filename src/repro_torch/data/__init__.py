"""Synthetic data pipelines (a copy of ``repro.data``)."""
