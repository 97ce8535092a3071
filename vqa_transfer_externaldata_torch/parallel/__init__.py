"""Training loop and optimizer of the port."""
