"""The port's client of the AM's control-plane RPC services."""
