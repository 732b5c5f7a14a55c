"""Training-state checkpoints: save, restore, the async writer."""
