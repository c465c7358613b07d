"""The benchmark of rebvio_tpu_torch (see README.md)."""
