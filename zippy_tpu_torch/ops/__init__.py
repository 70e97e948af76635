"""Device compute paths of zippy_tpu_torch: checksums and the DEFLATE encoder."""
