"""HTTP JSON REST API of the port."""
