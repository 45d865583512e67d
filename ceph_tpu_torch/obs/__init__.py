"""Observability: the placement-decision records (`placement.py`)."""
