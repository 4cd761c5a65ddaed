"""Accuracy-constraint levels of Table V (%), copied from the reference:
Min (72.8%), 80%, 85%, 89%, Max (89.9%)."""
from __future__ import annotations

CONSTRAINTS = {
    "Min": 72.8,
    "80%": 80.0,
    "85%": 85.0,
    "89%": 89.0,
    "Max": 89.9,
}
CONSTRAINT_ORDER = ("Min", "80%", "85%", "89%", "Max")
