"""Command-line tools of the port (``python -m
mocov2_whisper_flamingo_torch.tools.<name>``)."""
