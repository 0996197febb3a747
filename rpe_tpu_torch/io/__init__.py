"""Host-side image decoding (port of rpe_tpu/io)."""
