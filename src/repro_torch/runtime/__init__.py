"""Serving runtime: the prefetch pipeline over the q8 tier."""
