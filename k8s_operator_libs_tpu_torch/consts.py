"""Library logger.

Counterpart of ``k8s_operator_libs_tpu.consts.get_logger``; the port keeps
its own copy so that importing it never loads the JAX package.
"""

import logging


def get_logger(name: str = "tpu_operator_libs") -> logging.Logger:
    """Return the library logger (consumers configure handlers/levels)."""
    return logging.getLogger(name)
