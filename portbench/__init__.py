"""The port's benchmark (see ``harness.py``)."""
