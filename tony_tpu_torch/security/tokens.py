"""The task's side of the control plane's token auth.

The port's copy of what a task needs from `tony_tpu/security/tokens.py`:
the environment variable that carries this task's derived token
(`TOKEN_ENV`), the metadata keys it rides under, and `token_call_creds`,
the metadata a client attaches per call. Minting, deriving and verifying
tokens stay the AM's.
"""

from __future__ import annotations

from typing import Optional

TOKEN_METADATA_KEY = "tony-token"
TASK_ID_METADATA_KEY = "tony-task-id"
TOKEN_ENV = "TONY_SECURITY_TOKEN"


def token_call_creds(token: Optional[str],
                     task_id: Optional[str] = None) -> list[tuple[str, str]]:
    """Metadata a client attaches per call ([] when security is off). A
    task passes its `task_id` so the AM can re-derive its token."""
    if not token:
        return []
    meta = [(TOKEN_METADATA_KEY, token)]
    if task_id:
        meta.append((TASK_ID_METADATA_KEY, task_id))
    return meta
