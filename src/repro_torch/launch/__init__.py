"""Launchers of the port: the single-device serving driver."""
