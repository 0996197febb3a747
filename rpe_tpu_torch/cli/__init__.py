"""Command-line runners (port of rpe_tpu/cli)."""
