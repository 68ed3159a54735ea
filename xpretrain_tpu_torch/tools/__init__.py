"""Measurement tools of the port (run as ``python -m xpretrain_tpu_torch.tools.<name>``)."""
