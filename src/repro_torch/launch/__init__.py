"""Step builders and the serving launcher."""
