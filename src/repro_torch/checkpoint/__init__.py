"""Checkpoints in the reference's byte format."""
