"""PyTorch/CUDA port of the tony_tpu compute plane, for NVIDIA Hopper.

It mirrors `tony_tpu`'s module paths: `ops/` (with the hand-written CUDA
kernels in `csrc/`), `models/`, `parallel/`, `serve/`, `train/`, and the
task side of the orchestration layer (`conf.py`, `security/`, `rpc/`,
`observability/`). It imports torch and never jax or anything of
`tony_tpu`; the JAX package stays the reference the port's tests hold it
against.
"""
