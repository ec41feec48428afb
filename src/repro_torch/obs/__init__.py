"""Quality observability helpers."""
