"""LoopTune ported to PyTorch and CUDA (see README, "PyTorch / CUDA port")."""
