"""Multi-device rendering: the row-sharded frame."""
