"""Synthetic training data."""
