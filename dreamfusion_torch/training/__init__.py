"""Training: optimizer setup and the Trainer (train side)."""
