"""Submission client.

Equivalent of the reference's TonyClient.java (tony-core) + the tony-cli
front-ends: builds the cascaded conf, validates limits, stages resources,
spawns the ApplicationMaster, and monitors the app to completion.
"""

from tony_tpu_torch.client.tony_client import TonyClient, ClientListener

__all__ = ["TonyClient", "ClientListener"]
