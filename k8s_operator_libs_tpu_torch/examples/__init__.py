"""Examples of the port's library in use: ``consumer_operator``, a copy
of the repository's ``examples/consumer_operator.py`` on the port."""
