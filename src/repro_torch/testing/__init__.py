"""Equivalence checkers for the port (run as modules)."""
