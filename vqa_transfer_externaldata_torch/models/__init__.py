"""Model families and the registry."""
