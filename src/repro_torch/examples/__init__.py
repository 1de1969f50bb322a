"""The JAX package's examples on the port, each runnable as
``python -m repro_torch.examples.<name>`` (on the card unless given
``--device cpu``): ``quickstart``, ``serve_lm``, ``serve_engine``,
``train_lm``, ``bsps_cannon`` and ``bsps_spmv``."""
