"""Runnable examples of the port (``python -m ray_rust_tpu_torch.examples.<name>``)."""
