"""Shape corrections."""
