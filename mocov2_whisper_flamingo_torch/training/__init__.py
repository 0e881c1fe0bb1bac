"""Optimizer, task and trainer of the port (counterpart of ``training/``)."""
