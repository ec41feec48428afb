"""Synthetic corpora shaped like the paper's datasets."""
