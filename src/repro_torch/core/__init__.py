"""Saturn's core: the Parallelism Library."""
