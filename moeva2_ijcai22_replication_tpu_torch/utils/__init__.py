"""Configuration, artifact IO, timers and event streams of the port."""
