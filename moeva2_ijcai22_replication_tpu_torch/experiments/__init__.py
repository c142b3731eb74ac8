"""Experiment runners of the port: a config in, ``metrics_*.json`` out."""
