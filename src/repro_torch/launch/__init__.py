"""Launchers of the port: the serving path, its runner registry and the
training launcher."""
