"""Command-line tools built on the port (``python -m plutracer_tpu_torch.tools.<name>``)."""
