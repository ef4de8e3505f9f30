"""Roofline terms of one step on the H100, from the dry-run's op counts."""
