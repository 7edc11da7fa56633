"""Control-plane token auth: the app secret, the per-task tokens derived
from it, and the interceptor the port's gRPC servers install."""

from tony_tpu_torch.security.tokens import (
    TOKEN_ENV, derive_task_token, read_token_file, token_call_creds,
)

__all__ = ["TOKEN_ENV", "derive_task_token", "read_token_file",
           "token_call_creds"]
