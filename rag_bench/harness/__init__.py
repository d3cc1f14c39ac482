"""The harness: traffic, weights, the serving stack's hooks, the window, the
trace, the statistics and the check that decides ``correct``."""
