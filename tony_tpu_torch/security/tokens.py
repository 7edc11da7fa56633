"""The control plane's token auth: the port's copy of
`tony_tpu/security/tokens.py`.

The client mints the app secret (`generate_token`) and writes it into
the app dir with owner-only permissions (`write_token_file`); the AM
reads it back (`read_token_file`) and hands each container only its
derived token (`derive_task_token`, carried in `TOKEN_ENV`); a proxy or
portal surface gets a token in a separate HMAC namespace
(`derive_proxy_token`). `token_call_creds` is the metadata a client
attaches per call, and `token_auth_interceptor` makes the server
interceptor the executor's TaskLogService runs behind: a call must carry
the app secret, or a task token derived from it for an allowlisted
method whose payload names that task. `grpc` is imported only when an
interceptor is built.
"""

from __future__ import annotations

import hmac
import os
import secrets
from typing import Any, Optional

TOKEN_METADATA_KEY = "tony-token"
TASK_ID_METADATA_KEY = "tony-task-id"
TOKEN_FILE = ".tony-token"
TOKEN_ENV = "TONY_SECURITY_TOKEN"

# Task-plane methods a per-task token may call, with the payload fields
# naming the task they act on. Methods absent here fail closed.
TASK_METHOD_IDENTITY = {
    "get_cluster_spec": ("task_id",),
    "register_worker_spec": ("task_id",),
    "register_tensorboard_url": ("task_id",),
    "register_serving_endpoint": ("task_id",),
    "task_executor_heartbeat": ("task_id",),
    "register_execution_result": ("job_name", "job_index"),
    "update_metrics": ("task_type", "index"),
}


def generate_token() -> str:
    return secrets.token_hex(32)


def derive_task_token(secret: str, task_id: str) -> str:
    """Per-task token: HMAC-SHA256(app secret, "task:<task id>")."""
    return hmac.new(secret.encode(), f"task:{task_id}".encode(),
                    "sha256").hexdigest()


def derive_proxy_token(secret: str, name: str) -> str:
    """Transport-only token for a proxy/portal surface, in a DISTINCT HMAC
    namespace from task tokens: a leaked proxy token (browser history,
    Referer) must never double as an AM RPC credential — `derive_task_token`
    output would (the interceptor accepts any valid task:<id> pair)."""
    return hmac.new(secret.encode(), f"proxy:{name}".encode(),
                    "sha256").hexdigest()


def write_token_file(app_dir: str, token: str) -> str:
    """Persist the app secret with owner-only permissions."""
    path = os.path.join(app_dir, TOKEN_FILE)
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
    try:
        os.write(fd, token.encode())
    finally:
        os.close(fd)
    return path


def read_token_file(app_dir: str) -> Optional[str]:
    """The app secret the client wrote into the app dir, or None."""
    path = os.path.join(app_dir, TOKEN_FILE)
    try:
        with open(path, "r", encoding="utf-8") as f:
            return f.read().strip() or None
    except FileNotFoundError:
        return None


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


def _payload_identities(req: Any) -> list[str]:
    """Every task identity the payload expresses, in task-id form."""
    ids = []
    if isinstance(req, dict):
        if "task_id" in req:
            ids.append(str(req["task_id"]))
        if "job_name" in req and "job_index" in req:
            ids.append(f"{req['job_name']}:{req['job_index']}")
        if "task_type" in req and "index" in req:
            ids.append(f"{req['task_type']}:{req['index']}")
    return ids


def token_auth_interceptor(token: str):
    """A `grpc.ServerInterceptor` that refuses, UNAUTHENTICATED, a call
    without a valid token: the app secret passes everything; a task token
    plus its task id in `tony-task-id` passes only the methods of
    TASK_METHOD_IDENTITY, and only when every identity in the payload is
    that task (PERMISSION_DENIED otherwise)."""
    import grpc

    def _bind_task_identity(handler, task_id: str):
        if handler is None or handler.unary_unary is None:
            return handler
        inner = handler.unary_unary

        def bound(request, context):
            ids = _payload_identities(request)
            if not ids or any(i != task_id for i in ids):
                context.abort(grpc.StatusCode.PERMISSION_DENIED,
                              "payload identity does not match "
                              "authenticated task")
            return inner(request, context)

        return grpc.unary_unary_rpc_method_handler(
            bound, request_deserializer=handler.request_deserializer,
            response_serializer=handler.response_serializer)

    class TokenAuthInterceptor(grpc.ServerInterceptor):
        def __init__(self):
            def deny(request, context):
                context.abort(grpc.StatusCode.UNAUTHENTICATED,
                              "missing or invalid tony token")

            def forbid(request, context):
                context.abort(grpc.StatusCode.PERMISSION_DENIED,
                              "method not allowed for a task token")

            self._deny = grpc.unary_unary_rpc_method_handler(deny)
            self._forbid = grpc.unary_unary_rpc_method_handler(forbid)

        def intercept_service(self, continuation, handler_call_details):
            meta = dict(handler_call_details.invocation_metadata or ())
            supplied = meta.get(TOKEN_METADATA_KEY, "")
            if secrets.compare_digest(supplied, token):
                return continuation(handler_call_details)
            task_id = meta.get(TASK_ID_METADATA_KEY, "")
            if task_id and secrets.compare_digest(
                    supplied, derive_task_token(token, task_id)):
                method = handler_call_details.method.rsplit("/", 1)[-1]
                if method not in TASK_METHOD_IDENTITY:
                    return self._forbid
                return _bind_task_identity(
                    continuation(handler_call_details), task_id)
            return self._deny

    return TokenAuthInterceptor()
