"""Entry points (run via `python -m`): snn."""
