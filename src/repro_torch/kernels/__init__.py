"""Hand-written CUDA C++ kernels for Hopper (``csrc/``), their wrappers
and plain versions (``ops``), and their build (``build``)."""
