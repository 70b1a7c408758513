"""Standalone tools of the port."""
