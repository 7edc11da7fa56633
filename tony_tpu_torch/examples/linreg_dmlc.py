"""Linear regression under the MXNet (DMLC) runtime env: the port of
``examples/linearregression-mxnet/linreg_dmlc.py``.

The executor's mxnet runtime renders DMLC_ROLE, DMLC_PS_ROOT_URI,
DMLC_PS_ROOT_PORT, DMLC_NUM_SERVER and DMLC_NUM_WORKER. The script checks
them; the scheduler and server roles then exit 0 (MXNet daemons would
serve there), and a worker fits y = x @ w by 100 steps of gradient
descent (lr 0.1, batches of 256 from `synthetic_linreg`). It fails when
the last batch's MSE is not below 0.01.

    DMLC_ROLE=worker DMLC_PS_ROOT_URI=127.0.0.1 DMLC_PS_ROOT_PORT=9000 \\
    DMLC_NUM_SERVER=1 DMLC_NUM_WORKER=1 \\
        python -m tony_tpu_torch.examples.linreg_dmlc --device cpu
"""

from __future__ import annotations

import argparse
import os
import sys

if __package__ in (None, ""):
    sys.path.insert(0, os.environ.get(
        "TONY_REPO_ROOT",
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")))

STEPS, BATCH, LEARNING_RATE, MAX_MSE = 100, 256, 0.1, 0.01


def fit(device: str) -> float:
    """The worker's fit; returns the last batch's MSE."""
    import torch

    from tony_tpu_torch.device import resolve_device
    from tony_tpu_torch.train.data import synthetic_linreg

    device = resolve_device(device)
    data = synthetic_linreg(BATCH)
    w = torch.zeros((10,), device=device, requires_grad=True)
    loss = None
    for _ in range(STEPS):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in next(data).items()}
        loss = torch.mean((batch["x"] @ w - batch["y"]) ** 2)
        (grad,) = torch.autograd.grad(loss, w)
        with torch.no_grad():
            w -= LEARNING_RATE * grad
    return float(loss.detach())


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="tony_tpu_torch.examples."
                                          "linreg_dmlc")
    parser.add_argument("--device", default="cuda",
                        help="torch device (cuda or cpu)")
    args = parser.parse_args(argv)
    role = os.environ.get("DMLC_ROLE")
    root_uri = os.environ.get("DMLC_PS_ROOT_URI")
    root_port = os.environ.get("DMLC_PS_ROOT_PORT")
    n_server = os.environ.get("DMLC_NUM_SERVER")
    n_worker = os.environ.get("DMLC_NUM_WORKER")
    if not all([role, root_uri, root_port, n_server, n_worker]):
        print("missing DMLC env", file=sys.stderr)
        return 1
    print(f"DMLC env ok: role={role} root={root_uri}:{root_port} "
          f"servers={n_server} workers={n_worker}")
    if role in ("scheduler", "server"):
        return 0
    mse = fit(args.device)
    print(f"final mse {mse:.6f}")
    return 0 if mse < MAX_MSE else 1


if __name__ == "__main__":
    sys.exit(main())
