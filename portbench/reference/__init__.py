"""The plain references the benchmark judges the port by.

Plain PyTorch and NumPy, computed from the configuration and the inputs
the benchmark made.  Nothing here imports JAX, the JAX package or the
port (the import guard checks these files), and nothing takes a weight,
a table or a result the port derived.

Each takes a ``precision``: ``"bf16"`` is what the configurations state;
``"fp8"`` is the control, the nearest precision below, which has to come
out as not correct.
"""
