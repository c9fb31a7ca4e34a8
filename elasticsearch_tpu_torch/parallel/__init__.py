"""Host-side orchestration of the port: the build-aside / swap discipline."""
