"""The names the port shares with the orchestrator.

The port's own copy of the entries it needs from `tony_tpu/constants.py`
(which it does not import): the same names and the same values, so a
trainer of either package speaks the same exit codes and reads the same
environment.
"""

# Checkpoint retention: committed step directories the trainer keeps after
# each commit (the executor renders it from tony.checkpoint.keep; 0 = keep
# everything).
CHECKPOINT_KEEP = "TONY_CHECKPOINT_KEEP"

# The trainer left through its SIGTERM-driven emergency checkpoint
# (checkpoint-then-evict preemption or an operator stop).
EXIT_PREEMPTED = 12
