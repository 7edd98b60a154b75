"""Checkpoint store."""
