"""Tiered embedding cache: device slot pool over a host cold tier."""
