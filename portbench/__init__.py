"""The port's benchmark: one command runs one cell (a configuration under a
training mix) of ``flnerf_tpu_torch`` on CUDA cards and prints one JSON line.
See ``run.py``."""
