"""Shared logging-verbosity constants.

Capability parity with the reference's ``pkg/consts/consts.go:24-29`` (logr
verbosity levels Error=-2 … Debug=1, zap-calibrated).  Python's stdlib
``logging`` uses the inverse convention (higher = more severe), so we map the
four levels onto stdlib levels and keep the reference's names so call sites
read the same.
"""

import logging

# Reference: pkg/consts/consts.go:24-29 (LogLevelError=-2 … LogLevelDebug=1).
# Mapped onto Python stdlib logging levels.
LOG_LEVEL_ERROR = logging.ERROR
LOG_LEVEL_WARNING = logging.WARNING
LOG_LEVEL_INFO = logging.INFO
LOG_LEVEL_DEBUG = logging.DEBUG


def get_logger(name: str = "tpu_operator_libs") -> logging.Logger:
    """Return the library logger (consumers configure handlers/levels)."""
    return logging.getLogger(name)
