"""The PyTorch/CUDA port's benchmark: ``python3 portbench/run.py``."""
