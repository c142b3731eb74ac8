"""Schema, codec, norms and constraint sets of the port."""
