"""Staging and object-store access for the port: the shared-directory and
`gs://` stores its checkpoints, its executor's localization and its AM's
staging use."""

from tony_tpu_torch.storage.store import (   # noqa: F401
    GCSStore, LocalDirStore, StagingStore, fetch_uri, location_store,
    staging_store,
)
