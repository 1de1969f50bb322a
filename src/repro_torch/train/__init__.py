"""Training runtime of the port: steps, loop, checkpoint/restart, stragglers."""
