"""rays subpackage of flnerf_tpu_torch (mirrors flnerf_tpu/rays)."""
