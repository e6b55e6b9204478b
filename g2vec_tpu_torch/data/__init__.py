"""Synthetic reference-format datasets (small / medium / example scales)."""
