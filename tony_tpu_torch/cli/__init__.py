"""Submission front-ends.

Equivalent of the reference's tony-cli module
(tony-cli/src/main/java/com/linkedin/tony/cli/): ClusterSubmitter (production
submit), LocalSubmitter (ephemeral local run), NotebookSubmitter (single-node
interactive app behind a TCP proxy). Entry: `python -m tony_tpu_torch.cli <cmd>`.
"""
