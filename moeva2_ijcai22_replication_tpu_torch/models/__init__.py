"""Surrogate classifiers and feature scalers of the port."""
