"""Attacks of the port."""
