"""Configuration subsystem (reference: TonyConfigurationKeys.java + tony-default.xml)."""

from tony_tpu_torch.conf.configuration import (
    TonyConfiguration,
    parse_memory_mb,
    parse_time_ms,
)
from tony_tpu_torch.conf import keys

__all__ = ["TonyConfiguration", "parse_memory_mb", "parse_time_ms", "keys"]
