"""Stream-backed data pipeline of the port (prefetch = host-level hypersteps)."""
