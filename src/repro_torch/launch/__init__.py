"""Launchers of the port: serving, the tuning pre-pass and training."""
