"""Plain PyTorch references of the benchmark's models: one module per
architecture, each importing nothing of the program."""
