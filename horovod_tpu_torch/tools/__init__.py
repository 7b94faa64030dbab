"""Command-line tools of the port (``python -m horovod_tpu_torch.tools.<name>``)."""
