"""Host hot tier (q8 postings) and the flash tier for exact re-rank."""
