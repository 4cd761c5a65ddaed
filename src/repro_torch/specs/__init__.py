"""Observation layout (feature blocks and spec variants)."""
