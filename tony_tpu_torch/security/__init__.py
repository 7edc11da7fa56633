"""The task token the port's RPC client and drain route present."""
