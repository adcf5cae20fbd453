"""Subpackage of ray_rust_tpu_torch."""
