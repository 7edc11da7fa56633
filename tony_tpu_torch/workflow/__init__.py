"""Workflow-engine adapters (tony-azkaban equivalent)."""

from tony_tpu_torch.workflow.adapter import TonyWorkflowJob

__all__ = ["TonyWorkflowJob"]
