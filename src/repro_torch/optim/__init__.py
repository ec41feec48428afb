"""Optimizers (port of ``repro.optim``)."""
from .adamw import AdamWConfig, AdamWState, apply, cosine_schedule, init
