"""Config helpers and checkpoint restore (the training loop is not ported yet)."""
