"""Object-store access for the port: the `gs://` store its checkpoints
use."""
