"""Checkpoint store (port of ``repro.ckpt``)."""
from .store import latest_step, restore, save
