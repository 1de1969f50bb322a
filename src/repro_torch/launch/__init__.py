"""Launchers of the port: the serving path and its runner registry."""
