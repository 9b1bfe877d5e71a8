"""The benchmark's own code: the run record, the import guard, the device
and trace readers, the work counts, the fleet and the two loops
(the gate loop and the roll loop).  Nothing here imports JAX or
the JAX package; the port is imported only by the loops and the fleet."""
