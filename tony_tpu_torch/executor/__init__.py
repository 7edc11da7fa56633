"""The task executor: the per-container agent between the AM and a port
process, the port's copy of `tony_tpu/executor/`.

It registers with the AM, waits at the gang barrier, renders the
framework's rendezvous env (`runtimes.py`), heartbeats, runs the user
command, reports its RSS and the card's duty cycle and memory
(`task_monitor.py`, `cuda_metrics.py`; nvidia-smi's GPU plane in
`gpu_metrics.py`) and registers its exit code. Run it as ``python -m
tony_tpu_torch.executor``. No module here imports torch, and grpc loads
only when a client or server is built.
"""

from tony_tpu_torch.executor.task_executor import TaskExecutor

__all__ = ["TaskExecutor"]
