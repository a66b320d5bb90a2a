"""Training and inference plumbing of the port."""
