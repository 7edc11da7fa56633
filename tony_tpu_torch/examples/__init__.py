"""The TonY example entry points of the JAX package's models, on the port.

Each file keeps the name of the JAX script it mirrors under `examples/`
and takes that script's flags plus ``--device`` (``cuda`` unless
``--device cpu`` is given). Each runs as ``python -m
tony_tpu_torch.examples.<name>`` and by path (TonY's ``--executes`` takes a
path): run by path it puts ``$TONY_REPO_ROOT`` (else the checkout two
directories up) on ``sys.path``, as the JAX examples do.

- `generate_demo`: greedy or sampled decode from a Llama or MoE preset,
  or speculative decoding with ``--draft-config`` (``GENERATE_OK``).
- `train_allreduce`: ResNet or ViT trained data-parallel, with the
  Horovod-style rendezvous from ``CLUSTER_SPEC`` and ``TASK_INDEX``.
- `mnist_distributed`: the MNIST MLP; fails below 0.9 accuracy.
- `linreg_dmlc`: the DMLC env check, then a linear fit; fails when the
  MSE is not below 0.01.
- `pretrain_long`: long-context Llama training, the sequence over the
  mesh's sp axis (ring or Ulysses), with the Llama-3.1 RoPE rescale.
- `serve_submit`: submits a serving job through the client and, with
  ``--smoke``, answers one /v1/generate (``SERVE_SMOKE_OK``).
"""
