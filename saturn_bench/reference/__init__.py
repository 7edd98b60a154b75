"""The plain reference of a cell's training step: weights from a seed
(``params``), the forward pass and loss (``model``) and three AdamW
steps with the numbers that ``correct`` compares (``train``).

Plain PyTorch in float32 with TF32 off.  It imports nothing of the
program under test: what it shares with it is written again here from
the configuration file's keys.
"""
