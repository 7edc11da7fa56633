"""The port's side of the control-plane RPC: the clients of the AM's
services and the executor's TaskLogService."""
