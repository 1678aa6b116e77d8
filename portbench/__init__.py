"""The benchmark of ``dmx_compressor_tpu_torch`` on one H100 (see README.md)."""
