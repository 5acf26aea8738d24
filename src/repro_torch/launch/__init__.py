"""Launchers of the port: serving and the tuning pre-pass (training follows)."""
