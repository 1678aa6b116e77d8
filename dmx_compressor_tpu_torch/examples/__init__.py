"""Example scripts of the port, each run with ``python -m``."""
