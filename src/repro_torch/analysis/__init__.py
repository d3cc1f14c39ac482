"""Static analysis of the port (``analysis.lint``: repro-lint)."""
