"""The benchmark of opencalibration_tpu_torch (see cell.py)."""
