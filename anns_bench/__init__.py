"""The benchmark of ``repro_torch`` on one H100: ``run.py`` runs one cell
once.  See ``BENCHMARK.json`` at the root of the repository."""
