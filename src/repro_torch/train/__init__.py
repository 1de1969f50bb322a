"""Training and serving steps of the port."""
