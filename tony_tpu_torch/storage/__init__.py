"""Staging and object-store access for the port: the shared-directory and
`gs://` stores its checkpoints and its executor's localization use."""
