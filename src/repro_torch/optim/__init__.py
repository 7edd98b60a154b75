"""Optimizer: AdamW and its learning-rate schedules."""
