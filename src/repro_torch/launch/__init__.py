"""Launchers: the torch device plane and the serving driver."""
