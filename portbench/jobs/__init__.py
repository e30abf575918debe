"""Job kinds, one module each, found by the ``job`` name of a traffic
file."""
