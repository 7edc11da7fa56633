"""Control-plane token auth: the app secret the client mints, the
per-task tokens derived from it, and the interceptor the port's gRPC
servers install."""

from tony_tpu_torch.security.tokens import (
    TOKEN_ENV, derive_task_token, generate_token, read_token_file,
    token_call_creds, write_token_file,
)

__all__ = ["TOKEN_ENV", "derive_task_token", "generate_token",
           "read_token_file", "token_call_creds", "write_token_file"]
