"""TonyWorkflowJob: run a training job from workflow-engine properties.

Equivalent of the reference's Azkaban jobtype plugin
(tony-azkaban/.../TonyJob.java:38-169 + TonyJobArg.java): a workflow engine
hands the job a flat properties map; every `tony.*` property is written into
a job conf file in the working dir (the reference wrote tony.xml,
TonyJob.java:73-104), the special properties become client CLI args
(TonyJobArg enum), and the client is invoked in-process (the reference
launched `java ... com.linkedin.tony.TonyClient`, getJavaClass :107-110).

The port's copy of `tony_tpu/workflow/adapter.py`: it submits through the
port's own `TonyClient`, so the AM it launches is `-m tony_tpu_torch.am`.
The adapter is engine-agnostic: Azkaban, Airflow (PythonOperator calling
`TonyWorkflowJob(props).run()`), or any scheduler that can call Python.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Mapping, Optional

from tony_tpu_torch.client.tony_client import TonyClient
from tony_tpu_torch.conf import keys as K

LOG = logging.getLogger(__name__)

# special (non-tony.*) properties → client CLI flags, mirroring TonyJobArg
ARG_PROPS = {
    "src_dir": "--src_dir",
    "hdfs_classpath": None,               # parity: no HDFS in local backend
    "executes": "--executes",
    "task_params": "--task_params",
    "python_venv": "--python_venv",
    "python_binary_path": "--python_binary_path",
}

# reference wrote tony.xml into the workdir; a file name, not a conf key
CONF_FILE_NAME = "tony.json"


class TonyWorkflowJob:
    def __init__(self, props: Mapping[str, str],
                 working_dir: Optional[str] = None):
        self.props = dict(props)
        self.working_dir = os.path.abspath(working_dir or os.getcwd())
        self.client: Optional[TonyClient] = None

    # -- pieces (unit-testable, mirroring TonyJob's helpers) ---------------
    def tony_conf_entries(self) -> dict[str, str]:
        """All `tony.*` properties pass straight into the job conf
        (TonyJob.java:73-104)."""
        return {k: v for k, v in sorted(self.props.items())
                if k.startswith(K.TONY_PREFIX)}

    def write_conf_file(self) -> str:
        os.makedirs(self.working_dir, exist_ok=True)
        path = os.path.join(self.working_dir, CONF_FILE_NAME)
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.tony_conf_entries(), f, indent=1, sort_keys=True)
        return path

    def build_argv(self) -> list[str]:
        """Client argv from the special properties (TonyJobArg mapping,
        TonyJob.java:118-156)."""
        argv = ["--conf_file", self.write_conf_file()]
        for prop, flag in ARG_PROPS.items():
            value = self.props.get(prop, "")
            if value and flag:
                argv += [flag, value]
        return argv

    # -- the job -----------------------------------------------------------
    def run(self) -> int:
        """Submit and wait; returns the process-style exit code the workflow
        engine keys success off (0 ok, nonzero failed)."""
        argv = self.build_argv()
        LOG.info("workflow job argv: %s", argv)
        self.client = TonyClient()
        self.client.init(argv)
        ok = self.client.run()
        return 0 if ok else 1

    def cancel(self) -> None:
        """Engine-initiated kill (Azkaban job cancel → client kill hook)."""
        if self.client is not None:
            self.client.kill()
