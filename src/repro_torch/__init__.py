"""PyTorch port of the ``repro`` package for one NVIDIA H100.

The layout mirrors ``src/repro/``: each module here answers to the module
of the same relative path there, which stays the reference. This package
imports ``torch``, numpy and the standard library only — never ``jax``
and never ``repro``. The host-side modules that hold no JAX code
(``config.py``, ``configs/``, ``core/{workload,hetero,priority,
controller,paging}.py``, ``control/{config,projection}.py``,
``telemetry/{estimator,trace}.py``) are kept here as copies with their
imports renamed, so the controller's decisions match the reference's by
construction.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU and without that request they raise.
"""
