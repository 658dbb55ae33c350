"""Visualization helpers: for now only the numpy-only PNG codec."""
