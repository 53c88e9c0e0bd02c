"""Synthetic input pipelines."""
