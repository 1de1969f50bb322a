"""Optimizer, learning-rate schedules and gradient compression of the port
(counterparts of the JAX package's ``repro.optim``)."""
