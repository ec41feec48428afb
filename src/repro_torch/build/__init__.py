"""Index construction: fused k-means and the staged build pipeline."""
