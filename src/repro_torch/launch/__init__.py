"""Launchers of the port: the serving path, its runner registry, the
training launcher, the dry-run plan report and the mesh constructors."""
