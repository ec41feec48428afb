"""The model families (port of ``repro.models``): ``recsys``, ``lm`` and
``gnn``."""
