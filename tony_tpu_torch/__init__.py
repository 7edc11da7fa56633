"""PyTorch/CUDA port of tony_tpu, for NVIDIA Hopper.

It mirrors `tony_tpu`'s module paths: `ops/` (with the hand-written CUDA
kernels in `csrc/`), `models/`, `parallel/`, `serve/`, `train/`, the
orchestration layer (`conf/`, `security/`, `rpc/`, `observability/`,
`events/`), the task executor (`executor/`, with the helpers it needs in
`utils/` and `storage/`), the ApplicationMaster core (`am/`, `session/`,
`cluster/`, with the warm pool and the remote backend), and the client
and CLI (`client/`, `cli/`, `proxy.py`, with the native relay's sources
in `native/`). It imports torch and never jax or anything of
`tony_tpu`; the JAX package stays the reference the port's tests hold it
against.
"""
