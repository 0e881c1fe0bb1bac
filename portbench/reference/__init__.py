"""Plain PyTorch reference of the benchmarked model: no import of the program."""
