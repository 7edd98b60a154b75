"""Parallelism techniques, plans and the executable job."""
