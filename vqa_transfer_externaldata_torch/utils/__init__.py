"""Framework-neutral helpers: vocab, logging, checkpoints, weight bridge."""
