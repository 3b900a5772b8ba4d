"""The window's loops, one file a driver: ``run(ctx) -> Window``."""
