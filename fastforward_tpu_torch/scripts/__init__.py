"""Scripts of the port that run on the card (``python -m
fastforward_tpu_torch.scripts.<name>``)."""
