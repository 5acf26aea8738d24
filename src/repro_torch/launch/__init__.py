"""Launchers of the port (serving; tuning and training follow)."""
