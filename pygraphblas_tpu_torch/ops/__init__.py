"""Operator semantics tables (``table.py``)."""
