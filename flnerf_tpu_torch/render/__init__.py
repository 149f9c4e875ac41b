"""Renderers of the port (flnerf_tpu/render)."""
