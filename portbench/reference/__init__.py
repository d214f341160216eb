"""The plain PyTorch reference of the benchmark's configurations: their
weights made again from the run's seed (``weights``) and their forward pass
in float32 (``model``). Imports nothing of the program."""
