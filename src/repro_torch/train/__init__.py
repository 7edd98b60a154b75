"""Step functions."""
