"""Tabular domains of the port: LCLD and its synthetic data."""
