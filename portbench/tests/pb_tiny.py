"""Tiny cells for the CPU tests: configuration and traffic files written
into a temporary directory, and a BENCHMARK-like dict naming them."""

import json
import os

DENSE = {"source": "tiny", "hidden_size": 64, "intermediate_size": 128,
         "max_position_embeddings": 512, "num_attention_heads": 4,
         "num_hidden_layers": 2, "num_key_value_heads": 2,
         "rms_norm_eps": 1e-5, "rope_theta": 1000000.0,
         "torch_dtype": "bfloat16", "vocab_size": 256, "reduced": {},
         "assumed": {}, "reference": "llama"}
MOE = dict(DENSE, num_local_experts=4, num_experts_per_tok=2,
           router_aux_loss_coef=0.02, assumed={"capacity_factor": 1.25})
TRAIN = {"kind": "train", "batch": 2, "seq": 32, "remat_policy": "save_flash",
         "xent_chunk": 16, "schedule_steps": 100, "log_every": 10,
         "trace_steps": 2,
         "optimizer": {"name": "adamw", "lr": 0.0003, "warmup_steps": 10,
                       "weight_decay": 0.01, "b1": 0.9, "b2": 0.999,
                       "eps": 1e-08}}
OPEN = {"kind": "serve", "loop": "open", "rate_per_s": 6.0,
        "prompt": {"dist": "lognormal", "median": 24, "sigma": 0.8,
                   "min": 4, "max": 64},
        "answer": {"dist": "uniform", "min": 2, "max": 6}, "slots": 4,
        "token_budget": "longest", "queue_depth": 64, "sample_requests": 5,
        "trace_s": 1}
# offered far above what the tiny engine serves on a CPU: the backlog is
# cut at the close; LOW offers the same mix below it, which has to fail
SATURATED = dict(OPEN, rate_per_s=200.0, queue_depth=1024,
                 above_capacity=True)
LOW = dict(SATURATED, rate_per_s=2.0)
CLOSED = {"kind": "serve", "loop": "closed", "clients": 4, "per_client": 200,
          "prompt": {"dist": "lognormal", "median": 16, "sigma": 0.8,
                     "min": 4, "max": 32},
          "answer": {"dist": "uniform", "min": 8, "max": 24}, "slots": 4,
          "token_budget": 64, "queue_depth": 64, "sample_requests": 3,
          "trace_s": 1}


# the tiny cells' limits: between the unbroken tiny runs' readings (bf16
# against the f32 reference, six seeds: gradient 4.1e-4 to 1.2e-3, the
# change 3.6e-3 to 6.8e-3; the dense model's widest served gap 0 to 0.009;
# the MoE's mean gap up to 0.04) and the faults' (change 1, gradient 0.4;
# a mean gap of 2.5 or more) and, where the control separates at this
# size, the control's (gradient 7.0e-3 to 2.1e-2, the dense widest gap
# 0.11 to 0.18). The open-loop cells serve the MoE and are held, as the
# full-size one is, by the mean gap.
LIMITS = {"train": {"grad_gap": 0.003, "change_gap": 0.3},
          "open": {"logit_gap_mean": 0.5},
          "saturated": {"logit_gap_mean": 0.5},
          "closed": {"logit_gap": 0.05}}


def bench(tmp) -> dict:
    """Write the tiny files under `tmp`; the cells' BENCHMARK-like dict."""
    os.makedirs(os.path.join(tmp, "configs"), exist_ok=True)
    os.makedirs(os.path.join(tmp, "traffic"), exist_ok=True)
    for name, cfg in (("dense", DENSE), ("moe", MOE),
                      ("dense32", dict(DENSE, torch_dtype="float32"))):
        with open(os.path.join(tmp, "configs", f"{name}.json"), "w") as f:
            json.dump(cfg, f)
    for name, mix in (("train", TRAIN), ("open", OPEN), ("closed", CLOSED),
                      ("saturated", SATURATED), ("low", LOW)):
        with open(os.path.join(tmp, "traffic", f"{name}.json"), "w") as f:
            json.dump(mix, f)
    cells = [("train", "dense", "train"), ("train32", "dense32", "train"),
             ("train_moe", "moe", "train"), ("open", "moe", "open"),
             ("closed", "dense", "closed"),
             ("saturated", "moe", "saturated"), ("low", "moe", "low")]
    return {
        "configs": [{"name": n, "file": f"configs/{n}.json"}
                    for n in ("dense", "moe", "dense32")],
        "workloads": [{"name": w, "config": c, "traffic": t, "chips": 1}
                      for w, c, t in cells],
        "end_to_end": [
            {"name": "setup_s", "unit": "s"},
            {"name": "train_tokens_per_s", "unit": "tokens/s",
             "workloads": ["train", "train32", "train_moe"]},
            {"name": "prompt_tokens_per_s", "unit": "tokens/s",
             "workloads": ["open", "saturated", "low"]},
            {"name": "serve_tokens_per_s", "unit": "tokens/s",
             "workloads": ["closed"]}],
        "per_layer": [
            {"name": "input_stall_ms.train", "unit": "ms",
             "workloads": ["train", "train_moe"]},
            {"name": "queue_wait_p95_ms.serve", "unit": "ms",
             "workloads": ["open", "saturated", "low"]},
            {"name": "decode_step_ms.decode", "unit": "ms",
             "workloads": ["closed"]}],
    }


def run(tmp, workload, fault="", trace=False, limits=None, seed=2**31 + 7,
        seconds=2.0, control=False):
    import time

    from portbench.run import run_cell
    b = bench(tmp)
    kind = "train" if workload.startswith("train") else "serve"
    lim = limits or ({"loss_rel": 1.0, "grad_gap": 1.0, "change_gap": 1.0}
                     if kind == "train" else {"logit_gap": 100.0})
    return run_cell(b, workload, seed, seconds, trace, device="cpu",
                    fault=fault, t_start=time.monotonic(), root=str(tmp),
                    traffic_dir=os.path.join(tmp, "traffic"), limits=lim,
                    control=control)
