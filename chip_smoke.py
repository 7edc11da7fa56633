#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (`tony_tpu_torch`) on one NVIDIA
Hopper card.

    python3 chip_smoke.py            # every phase, as the port's proof of life

Phases (any failure exits non-zero, and the result line is not printed):

1. build    — compile every hand-written CUDA kernel from `tony_tpu_torch/
              csrc/` (one nvcc per source, all at once); print the build
              seconds, nvcc's register report per kernel and the card's
              name and power limit; count the HGMMA (wgmma) instructions
              in the SASS of each bf16 flash kernel (forward and
              backward, cuobjdump) and fail if one has none.
   cache    — the kernel build cache: two task starts (`python -c`, the
              ops imported, `maybe_enable_compile_cache`, every source
              built and loaded) started together with
              $TONY_JAX_CACHE_DIR on an empty directory compile each
              source once between them (the build lock); a third
              compiles nothing and loads every source (the five that
              hold the six kernels); `python -m
              tony_tpu_torch.train --config tiny --steps 2` under the
              same variable compiles nothing and writes no library into
              `_build/`. Prints the cold and warm walls and the seconds
              saved per task start.
2. kernels  — call each kernel's wrapper at the shapes of the serving
              and training paths and hold it against its plain PyTorch
              version on the same inputs: elementwise (bf16 at 3e-2, f32
              at 2e-5 for the forwards and 2e-4 for the flash backward, as
              tests/test_ops.py holds the JAX kernels) and, for bf16
              flash outputs, by norm: ||got - want|| / ||want|| over the
              whole tensor and over each row of D, within 1e-2 (late rows
              are small, so an elementwise 3e-2 alone would pass a kernel
              that dropped their tiles), printing where the worst row is;
              print the errors, kernel ms, plain ms, the library call's ms
              and the bound (RMSNorm also with a cold L2). At the training
              shape the flash kernels run twice and must agree bit for
              bit, and print their TFLOP/s and share of the bound. K5
              (the W8A16 int8-weight product) at llama3_8b's decode
              products for 1 and 4 rows (bf16 at 3e-2 and by norm, twice
              and bit for bit), mixtral_proxy's products and its three
              expert banks (E 8, C 4: one launch a bank, against each
              expert's plain product), each K5 case's second call after
              a launch of another shape (a counter of the split sums
              left non-zero would show), the sum over one decode step's
              products of each model, and the tiny f32 path's shapes at
              2e-5; K5's library yardstick is torch._weight_int8pack_mm
              on the same int8 weight where it launches, and
              torch.matmul on the bf16 weight beside it. K6 (the
              decode attention) at DECODE_ATTN_CASES: Mistral 7B's 32
              slots at budget 3072 with every row full and at seeded
              lognormal lengths (median 900), Mixtral's 8 slots at 4112,
              one row at 4096, bench_350m's D64, llama3_1b_proxy's group
              of 2, groups of 1 and 8, tiny's f32 D16 and 300 rows (two
              launches): the output against its plain version (bf16 at
              3e-2 and by norm), the written cache rows and a second call
              bit for bit, one launch each 256 rows; timed against its
              byte bound, the plain version and
              scaled_dot_product_attention with a boolean mask over the
              budget; positions -1 and S write nothing and read 0.
3. serve    — the serving path at full width: `build_server` with
              llama3_8b (bf16, random weights from a fixed seed), 4 slots,
              a 2048-token budget; 8 concurrent HTTP /v1/generate requests
              (2 streamed) with prompts of 1 to 1900 tokens, 16 new tokens
              each. Checks every answer, /v1/metrics, and that the kernel
              launch counts are exactly what the path must launch (K6
              once a layer in each decode step; none with an int8
              cache).
4. engine   — `tiny` in f32 on the card: the engine's greedy streams under
              staggered arrivals equal the offline `generate`, and the
              forward on the card agrees with the forward on the CPU.
5. profile  — where a full-width prefill's and decode step's time goes
              (host wall, device busy time, idle share, top kernels).
   quant    — llama3_8b bf16 random weights quantized on the card:
              int8-weight, int8-cache and combined logits within a 5%
              normalized RMSE of bf16's (prefill and a decode step), the
              decode step's device time in the three modes, then the
              serve phase's burst on a `--quant int8 --quant-cache` server
              with exact K1, K4 and K5 launches.
   kvcache  — llama3_8b bf16: 8 prompts sharing a 1024-token prefix,
              one after another through an engine with prefix sharing on
              and one with it off: pool hits exact, K1 only for the
              unmatched admission, TTFT on against off, streams compared
              (divergences printed), first-token logits through sealed and
              gathered pages bit for bit those of the same suffix prefill
              on the prefix rows themselves (against the full K1 prefill
              printed), the suffix and full prefill profiled; a
              prefill-role and a decode-role server relaying over
              HTTP, bit-identical to local decode; tiny f32 on equal to
              off.
6. train    — the training path at full width: the Trainer that
              `python -m tony_tpu_torch.train` builds, on llama3_1b_proxy
              (full depth, bf16, random weights from a fixed seed) at
              batch 4 x 4096 tokens with save_flash remat, 5 steps of
              synthetic tokens plus one profiled step, in one run.
              Checks finite losses, the exact kernel launches of every
              step and peak device memory; prints the Trainer's own
              tokens/s and MFU (its metrics_history) and where a step's
              time goes. Then `tiny` f32 trains 3 SGD steps on the
              card and on the CPU: the same losses and parameters.
7. ckpt     — the training state's lifecycle at the train phase's full
              width and depth (llama3_1b_proxy, bf16, B4 x S4096), in a
              temporary directory that must hold three copies of the
              state: run A (2 steps, held-out eval, the final save),
              run C (4 steps, no checkpoint, the same init and data) and
              run B (a new Trainer resuming A's step 2 on the next
              batches, checkpoint_every 1, keep 1). Checks the restore bit
              for bit (every leaf and the lr), B against C (bitwise when
              A matches C bitwise, else within 4x A's gap or 1e-3
              relative), the eval loss against `llama_loss`, each step's
              and the eval's exact launches, the retained steps {2, 4},
              the server on B's checkpoint against `generate`, 3 steps
              with f32 master weights (params equal the cast master,
              peak memory), and SIGTERM on `python -m
              tony_tpu_torch.train` (exit 12, then resume). Prints the
              state's size, snapshot, commit and restore times, a
              checkpointed step against an unchecked one, and the
              master-weights step time, tokens/s, MFU and peak memory.
              Then the resume again on gs://chip-smoke/run, at the same
              full width and depth, through a gsutil stand-in (cp, ls
              and rm mapped onto a local directory, so the run needs no
              network and no bucket): run A' saves, run B' restores it
              bit for bit and resumes against run C (as above), retention
              keeps the pinned step beside the last, and the server on
              the gs:// checkpoint answers against `generate`; its commit
              and restore times are the stand-in's local-disk copies,
              not GCS.

8. orch     — the port as a TonY task, reporting to a recording AM
              stand-in (a gRPC server with the three methods a task calls,
              on the port's JSON codec, refusing a call without the task
              token), under the environment the executor renders and a
              frozen conf file. Training in this process: the train
              phase's Trainer with `--data` on a shard of 8 M random
              tokens, 8 steps, an eval every 4, a final checkpoint; checks
              the first batch against a numpy read of the shard, exact
              launches per step, the gauges, goodput phases (their sum
              within 1% of the wall) and spans the stand-in received, and
              prints stall_s per step, the goodput shares and the step
              interval beside the train phase's. As the chief with
              TB_PORT set, the Trainer serves the profiler page: GET /,
              a 2-step capture requested by POST /v1/profile (202 before
              the run), its Chrome trace fetched during the run holding
              the flash and RMSNorm kernels' device events at exactly
              two steps' launches; the port closes after run(), and a
              Trainer with IS_CHIEF=false binds nothing. Serving: `python -m
              tony_tpu_torch.serve --config llama3_8b` as a subprocess,
              four times (reports off, on, off, on), with the serve
              phase's burst; each "on" run checks the registration,
              /metrics, /v1/traces, /v1/drain (403 without the token, 200
              with it), and that SIGTERM re-registers the endpoint
              draining and exits 0. Prints tokens/s, decode and ITL p50,
              TTFT p50 and the profiler's own overhead for every run.
9. moe      — the mixture-of-experts Llama, mixtral_proxy (full width
              and depth, bf16, random weights from a fixed seed), through
              both entry points. Serve: the serve phase's burst on a
              `--config mixtral_proxy` server (no-drop capacity, cf 4)
              with exact K1 and K4 launches; each burst stream compared
              with offline `generate` (printed: the burst's 4-row decode
              products round otherwise than generate's 1-row ones), the
              streams held token for token at generate's own shapes (one
              slot), the prefill's last logits held to `moe_forward` at
              bf16's 3e-2; the prefill and decode step profiled with the
              MoE breakdown (expert products, dispatch gathers, router).
              int8: the weights quantized on the card; int8 logits (and
              with the int8 cache) on the bf16 model's routing within
              the 5% normalized RMSE of bf16's, printed beside the
              logits on their own routing and the top-2 choices that
              differ; K5's launches in one decode step exact (16 x (4 +
              3) + 1: one launch a product, one a bank); the int8 decode
              step profiled; the burst on a
              `--quant int8 --quant-cache` server with exact K1, K4 and
              K5 launches. Train: the train phase's run on mixtral_proxy
              (B4 x S4096, cf 1.25, save_flash, AdamW; 5 steps and a
              profiled one, exact launches, peak memory, tokens/s and MFU
              on the active parameters), then two fresh 2-step runs whose
              losses, parameters and AdamW moments are bitwise equal to
              each other's, and whose losses are the train run's first
              two.

10. parallel — the parallel layer on the one card. (a) The train phase's
              model and batch for 5 steps, first in this process on plain
              tensors, then as `python -m tony_tpu_torch.train` on an NCCL
              world of one (WORLD=1, RANK=0, INIT_METHOD on a free local
              port) with the mesh fsdp 1 x tp 1: it must log an nccl group,
              the mesh and 12 DTensor parameter leaves, never gloo; its 5
              losses and final parameters (its checkpoint's shard files)
              equal the plain run's bit for bit, its own logged kernel
              launches are exactly 5 steps' worth, and both median step
              times (steps 3-5) are printed. (b) llama3_1b_proxy's
              attention at B4 H16/8 S4096 D128 bf16 causal with the
              sequence over sp = 4 virtual ranks of 1024 tokens, in this
              process: the ring's own `_chunk_mode`, `_chunk_forward`,
              `merge_partials` and `_chunk_backward` with rotations by
              index (exactly 10 K1, 10 K2, 10 K3 launches; the 6 future
              pairs launch nothing), and Ulysses as head slices after the
              GQA broadcast (4 of each); out, lse, dQ, dK and dV within
              1e-2 by norm (lse 1e-4) of K1-K3 on the whole sequence and
              of the plain versions; each path's device time beside
              K1-K3's on the whole sequence.

11. pipeline — pipeline and expert parallelism on the one card. (a) The
              train phase's model (llama3_1b_proxy, random weights from a
              fixed seed) and batch (B4 x S4096) through
              `llama_loss_pipelined` on `LocalStages(4)`: the 16 layers
              as 4 stages run one after another in this process, a copy
              standing in for each send, with M 4 microbatches and v 1
              and v 2 chunks a stage, 3 runs each: every run's K1-K4
              launches exactly 128 / 64 / 64 / 385 (per layer and
              microbatch K1 in the forward tick and the recompute, K2
              and K3 once, RMSNorm in the forward tick, the recompute and
              its replay; the final norm once), the loss within 1e-3
              relative and every gradient within 1e-2 by norm of the
              plain step (forward and backward) on the same weights and
              batch, both timed; then K1-K4 held against their plain
              versions at the microbatch's shapes (B1 H16/8 S4096 D128
              causal; 4096 rows x 2048), K1-K3 twice and bit for bit.
              (b) `python -m tony_tpu_torch.train --pp-micro 4` on an NCCL
              world of one with a (pp 1, fsdp 1) mesh: 3 losses within
              1e-3 relative of the plain run's, its own count of its
              launches exact, both median steps. (c) mixtral_proxy at full
              width and 4 layers through the entry point on an NCCL world
              of one with an (ep 1, fsdp 1) mesh (`moe_param_axes`, the
              sharded MoE MLP): losses and checkpointed parameters bit for
              bit the plain run's, launches exact.

12. spec    — speculative decoding through the generate demo
              (`tony_tpu_torch.examples.generate_demo.run`, in this
              process) at full width: target llama3_1b_proxy, draft
              bench_350m (random, both vocab 32000), gamma 4, batch 4,
              prompt 128, 64 new tokens; then the target as its own draft,
              then `--quant int8 --quant-cache`, then a mixtral_proxy
              target at no-drop capacity (32 new tokens). Each run's K1,
              K4 and K5 launches exact for its round count; each stream
              held against greedy `generate` on the same weights: a row
              may part from it only at a token that the target window
              which emitted it (kept from a rerun giving the same
              stream) chose as its argmax over greedy's prefix, where
              that window shifted the pair (greedy's token, its own)
              by more than the decode step's margin between them
              (printed). Prints rounds, drafted tokens accepted a row a
              round, ms a round and tokens/s against greedy generate's
              (warm, the same call). tiny in f32 on the card: token for
              token greedy generate's (gamma 1, 3, 4, the int8 cache).
13. vision  — the image zoo and the small models through their entry
              points: `python -m tony_tpu_torch.examples.train_allreduce`
              with ViT (vit_s16_proxy, the example's 28/7 geometry, S 17)
              and ResNet (resnet50_proxy) on an NCCL world of one (one
              worker in CLUSTER_SPEC, a 1-rank fsdp mesh), its own count
              of its launches exact; the Trainer on vit_s16_proxy at
              224/16 (S 197), B 64, on numpy-seeded images, 6 steps: exact
              K1/K2/K3/K4 launches every step, step time, images/s, peak
              memory; mnist_distributed (accuracy >= 0.9) and linreg_dmlc
              (MSE < 0.01) through their mains; resnet_tiny and vit_tiny
              in f32: the card's logits against the CPU's at 2e-5.

14. executor — the port's task executor: `python -m
              tony_tpu_torch.executor` launched with the env the AM
              renders into a container (`_container_env`), against the
              recording AM stand-in (the gang barrier, heartbeats,
              results, metric pushes), metrics every 500 ms. One NVML
              read's cost and the monitor's whole card sample (median of
              100). (a) A pytorch worker running `python -m
              tony_tpu_torch.train` on llama3_1b_proxy B4 x S4096, 6
              steps: exit 0 registered, heartbeats never silent for 2.5
              s, the trainer's own count of its launches 6 x the train
              phase's step, a push with TPU_UTILIZATION >= 50,
              MAX_TPU_HBM_BYTES between its logged peak and the card's
              memory, and the executor never holding a context (NVML's
              process list, its /proc maps); the duty and memory series
              printed. (b) A wedge (a context, 1 GiB, one kernel, 6
              intervals asleep): TPU_UTILIZATION < 1 in 4 or more
              consecutive pushes while heartbeats flow, memory >= 1 GiB.
              (c) `python -m tony_tpu_torch.serve` as the serving task:
              its endpoint at the SERVING_PORT the executor rendered, one
              /v1/generate, SIGTERM to the executor: a draining
              re-registration, the executor's exit 151 (EXIT_KILLED_BY_AM
              & 0xFF). Each task's barrier wait and executor start ->
              user process start, from its spans.
15. am      — whole TonY jobs under the port's ApplicationMaster:
              `python -m tony_tpu_torch.am --app_id A --app_dir D` on a
              `tony-final.json` the port's TonyConfiguration froze, run
              from a temporary directory holding a copy of
              `tony_tpu_torch/` alone (PYTHONPATH set to it, the cwd
              outside the repo, `import tony_tpu` shown to fail there),
              the kernel build cache pointed at the libraries the build
              phase made. (a) One pytorch worker running `python -m
              tony_tpu_torch.train` on llama3_1b_proxy B4 x S4096, 6
              steps, metrics every 500 ms: the AM exits 0 with SUCCEEDED,
              the trainer's own count of its launches 6 x the train
              phase's step, the `.jhist` (parsed by the port's handler)
              holds APPLICATION_INITED, TASK_STARTED and
              APPLICATION_FINISHED in order, and the AM's metrics store
              (its history's metrics.json) received a TPU_UTILIZATION >=
              90 from the port's executor. (b) One serving task the AM
              launches as `python -m tony_tpu_torch.serve` (llama3_1b_
              proxy, 2 slots): its SERVING_UP address read from the
              container's stdout, one /v1/generate of 16 new tokens, then
              SIGTERM to the AM: the port closes, the server's own count
              holds K1 and K4 launches, and the history holds
              SERVING_ENDPOINT_REGISTERED. Prints the AM's start -> first
              container launch, the job's wall and the serving task's
              container launch -> SERVING_ENDPOINT_REGISTERED.

16. cli     — the port's client and CLI: `python -m tony_tpu_torch.cli
              submit` from the same copy of `tony_tpu_torch/` alone,
              each job one pytorch worker running `python -m
              tony_tpu_torch.train` on llama3_1b_proxy B4 x S4096, 2
              steps, kernels from the build cache. (a) On the local
              backend with `tony.warmpool.enabled` (one warm child): the
              CLI exits 0, status.json SUCCEEDED, the AM's log shows the
              worker's executor leased warm, the trainer's own count of
              its launches exactly 2 x the train phase's step, `cli logs
              <app> worker:0 --follow` (run beside the job) prints the
              trainer's launch line, `cli diagnose` finds no failure
              record, `cli alerts` finds no alert bundle (exit 1: no
              rule is set). (b) On the remote backend over
              the exec transport (two nodes on this host under one node
              root), staged through `tony.staging.location`: the CLI
              exits 0, the worker ran in a workdir under the node root
              holding the frozen conf it fetched from the store (equal
              to the store's object), `fleet/jobstate.json` in the store
              holds the jobstate keys and the final state, the same
              exact launches. Prints, for each job, CLI spawn -> AM
              start, the client_submit span, AM start -> first container
              launch, container launch -> user process start (the warm
              lease against the cold spawn), the user process's span,
              its end -> the application span's end -> CLI exit, the
              job's wall, and the phase's time.
17. fleet   — the serving fleet, from the same copy of `tony_tpu_torch/`
              alone: `cli submit` of a served llama3_1b_proxy (bf16,
              random weights from the entry point's seed, 2 slots a
              replica, 1 chip asked a replica) with the AM's autoscaler
              (1 to 3 replicas; up on a queue of more than 2 a replica
              for 2 passes of the 300 ms monitor; a 20 s cooldown; no
              scale-down), the arbiter's inventory at 2 chips, and the
              queue-depth alert at 4 (2 s / 4 s burn windows, 500 ms
              for); `cli router <app_dir>` in front. Burst A, 16 streams
              of prompt 256 and 64 new tokens through the router, 40 ms
              apart: the arbiter admits the scale-up, and the moment it
              does a second tenant (`cli submit` of a sleeping worker
              asking 2 chips into the same staging location) fills the
              inventory; serving:1 launches and registers. Burst B, the
              same 16 over both replicas: the next ask is queued. Held:
              every stream equals `generate` on the same weights (this
              process, one prompt at a time); the event record in order
              (the admitted decision, serving:1 started and registered, a
              queued decision at 2 replicas, no third replica;
              ALERT_FIRING for `serve.queue_depth_burn` inside burst A
              and its ALERT_RESOLVED before burst B); each replica's own
              /v1/metrics gained a request in burst B; `cli alerts`,
              `cli top --once` (the job RUNNING at 2 chips), `cli
              arbiter --chips 1` (queue) and `cli router --status` (2 UP
              endpoints) while the job runs; each replica's own count of
              its launches equal to its own admissions and decode steps;
              after SIGTERM to the CLIs, the router's and both replicas'
              ports closed. Prints TTFT p50/p95 a burst, scale-up ->
              registration, queue crossing -> ALERT_FIRING, the router's
              added wall (routed less direct, in turns) and the phase's
              seconds.

18. portal — the history portal and the workflow adapter, from the same
              copy of `tony_tpu_torch/` alone. (a) A workflow step (a
              script calling `TonyWorkflowJob(props).run()`) submits a
              job whose worker exits 3, staged through a local staging
              location with its history kept where the portal does not
              look: `run()` returns 1. (b) `python -m
              tony_tpu_torch.portal --port 0 --history-location H
              --history-store S` (mover and purger every second, a day's
              retention) prints its banner; the fetcher's first pass
              brings the failed job in from S: /api/jobs lists it FAILED,
              its diagnostics name exit 3. (c) The train phase's model
              and batch for 16 steps as a workflow step with its history
              under H: while it runs, /, /api/jobs (RUNNING) and
              /jobs/<id> answer, worker:0's stderr through the portal's
              live log route shows a step line and the next poll's
              offset advances, skew and alerts answer live from the AM
              (an MFU floor of 1% makes it run its alert engine), and
              `POST /api/jobs/<id>/profile` (worker:0, 2 steps) answers
              200. After `run()` returns 0: the mover files the job under
              finished/y/M/d, /api/jobs shows it SUCCEEDED, its events
              are the am phase's (TASK_FINISHED and the one
              PROFILE_CAPTURED of that request left out), the trainer's
              own count of its launches is exactly 16 x the train phase's
              step, a TPU_UTILIZATION point is >= 50, every
              TRAIN_MFU_PCT point and goodput's mfu_pct is a value the
              trainer logged, /config shows every tony.* prop, /api/fleet
              lists it at 1 chip, /metrics parses. SIGINT: the daemon
              exits 0. Prints workflow spawn -> AM start -> first
              container launch, spawn -> the first step line seen
              through the portal, the profile POST's round trip, the
              AM's verdict -> the job dir in finished/, and the phase's
              seconds; on a failure, the portal's, the AMs' and the
              workflow steps' output.
19. long   — long context and the last entry points. (a) K1-K3 at
              pretrain_long's attention, B1 H16/8 S32768 D128 bf16
              causal, held against `blockwise_forward` /
              `blockwise_backward` as the kernels phase holds them (twice
              and bit for bit), timed beside the plain versions and
              SDPA; they join the kernels line as each entry's "long".
              (b) The ring and Ulysses over SP_RANKS = 4 virtual ranks at
              that shape (8192 tokens a rank): exactly 10 and 4 launches
              of each of K1-K3, held against K1-K3 on the whole sequence
              and the plain versions. (c) `pretrain_long.main(
              ["--config", "llama3_1b_proxy", "--seq-len", "32768",
              "--batch-size", "1", "--rope-scaling", "8", "--steps",
              "4"])` in this process on an NCCL world of one (mesh fsdp 1
              x sp 1): full width and depth, each step's launches
              exactly the train phase's step (16/16/16/65), finite
              losses, the first within 0.5 of ln 32000, its last line;
              prints the median step, tokens/s, MFU and peak memory.
              Then step 1 at 2 layers (the same rescaled config, seeded
              weights, pretrain_long's first batch) through the kernels
              and through the plain versions (swapped in on the card for
              that one step): the loss within bf16's 3e-2 relative and
              every gradient within 1e-2 by norm. (d) `python -m
              tony_tpu_torch.examples.serve_submit --quant int8 --smoke`
              from the copy of `tony_tpu_torch/` alone, serving the ckpt
              phase's kept llama3_1b_proxy checkpoint (or, without that
              phase, one written by one step of `python -m
              tony_tpu_torch.train`) on one slot and a budget of prompt
              + new tokens (generate's shapes): exit 0 and
              SERVE_SMOKE_OK, the 16 tokens equal to `generate` in this
              process on the same restored and int8-quantized weights,
              the server's own K1, K4 and K5 counts exactly one
              admission's and 15 decode steps'. (e) `python -m
              tony_tpu_torch.tools.goodput_report` on that job's app dir:
              exit 0, its --json equal to the goodput.json it found, the
              table printed. Prints the phase's seconds.

`--phases build,kernels` (for instance) runs a subset; `--phases
build,moe` runs the MoE slice alone, `--phases build,parallel` the
parallel slice, `--phases build,pipeline` the pipeline and ep slice,
`--phases build,spec,vision` the model zoo, `--phases build,executor`
the task executor, `--phases build,am` the jobs under the port's AM,
`--phases build,cli` the jobs submitted through the port's CLI,
`--phases build,fleet` the serving fleet, `--phases build,portal` the
portal and the workflow adapter, `--phases build,long` long context,
the serving submitter and the goodput report.
The kernels phase also holds K1-K3 at ViT's attention shapes (B64 H6
S197 D64 and S17, non-causal, timed and bit for bit over two calls;
vit_tiny's D16 in f32) and K4 at its rows (64 x 197 and the 64 CLS
rows, D 384).

Two lines before the last is a JSON object with one entry per kernel
(`launches`: its launches on the serve, quant, kvcache, train, ckpt,
orch, moe, parallel, pipeline, spec, vision, executor, am, cli, fleet,
portal and long paths together, split in `launches_by_path`; the orch path counts its training
run, the ckpt path its runs and servers on the local and the gs://
directory, the moe path its two bursts and its training runs, the
parallel path the mesh run's own count of its launches, parallel_sp
the ring's and Ulysses' chunk launches, pipeline the one-process
pipelined runs, pipeline_entry and ep the pipelined and the (ep, fsdp) entry-point runs' own counts, spec
its four full-width runs, vision the ViT runs of train_allreduce (its own
count) and of the Trainer at 224/16, executor the trainer's own count
under the executor, am the trainer's and the server's own counts under
the port's AM, cli the trainer's own counts in the two jobs submitted
through the port's CLI, fleet the two replicas' own counts, portal the
trainer's own count in the workflow's training job, long
pretrain_long's steps and the serving submitter's server's own count,
long_sp the ring's and Ulysses' chunk launches at S32768; the cache
phase's processes are uncounted; K1-K3's entries carry the long
phase's shape as "long"), then the
card's name and power limit from nvidia-smi; the last line is {"ok":
true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import glob
import html
import io
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

SERVE_CONFIG = "llama3_8b"
# K1 at llama3_8b's head layout (B1 H32/8 D128 causal), at serving's prompt
# lengths, timed; the last is the timed summary
FLASH_SEQS = (1, 37, 512, 513, 2000)
# more bf16 K1 cases, held and not timed, (B, H, Hkv, S, D, causal):
# mixtral_proxy's prefill head layout at the longest prompt, bench_350m's
# D64, D32 and D16, each at a ragged S (not a multiple of the 128-key
# tile), a non-causal case, an H == Hkv case, a group of 4 at B2
FLASH_CASES = (
    (1, 16, 8, 1900, 128, True),
    (1, 16, 8, 1000, 64, True),
    (1, 4, 2, 100, 32, True),
    (2, 4, 4, 37, 16, True),
    (1, 32, 8, 1000, 128, False),
    (1, 8, 8, 513, 128, True),
    (2, 8, 2, 777, 128, True),
)
# (rows, D): serving's shapes (2000 x 4096 is the timed summary), the
# training path's (B4 x S4096 rows of llama3_1b_proxy's and
# mixtral_proxy's 2048), mixtral_proxy's serving rows, bench_350m's 1024,
# and two rows that are not a power of two: 1000 (bf16: 125 16-byte
# vectors, the vector path) and 1001 (not a whole number of 16-byte
# vectors in either dtype: the scalar path)
RMS_CASES = ((1, 4096), (4, 4096), (513, 4096), (2000, 4096),
             (16384, 2048), (4, 2048), (1900, 2048), (2000, 1024),
             (2000, 1000), (2000, 1001))
RMS_SUMMARY = (2000, 4096)
TOL = {"bfloat16": 3e-2, "float32": 2e-5}
BWD_TOL = {"bfloat16": 3e-2, "float32": 2e-4}
# bf16 flash outputs: the limit on the norm-wise relative error, over the
# whole tensor and over each row. Both sides round the same f32 sums to
# bf16, so they differ by at most one bf16 ulp (2^-7 relative) in a few
# elements; a dropped or misplaced tile costs its rows O(1).
NORM_TOL = 1e-2
# the limit on K1's lse at the training shape: both sides sum in f32, in
# another order, and the plain version scales q before the product where
# the bf16 kernel scales S after it
LSE_TOL = 1e-4
# (B, H, Hkv, S, D, causal, dtype) of the flash backward cases: the
# training shape of llama3_1b_proxy first (timed, and K1 held and timed
# there too), llama3_8b's head layout (group 4), bench_350m's (D 64),
# ragged S (not a multiple of 64 or 128) at every head dim, a non-causal
# case, an H == Hkv case, contiguous (B, H, S, D) operands (an eighth
# field "bhsd"; the others are `qkv_proj`'s (B, S, H, D) views); in bf16
# the tensor-core kernels, in f32 (D 128 S 1024 and small shapes) the
# CUDA-core ones
BWD_CASES = (
    (4, 16, 8, 4096, 128, True, "bfloat16"),
    (1, 32, 8, 2048, 128, True, "bfloat16"),
    (1, 16, 8, 1000, 128, True, "bfloat16"),
    (1, 16, 8, 37, 128, True, "bfloat16"),
    (2, 8, 2, 777, 128, True, "bfloat16"),
    (1, 16, 8, 1000, 128, False, "bfloat16"),
    (1, 8, 8, 512, 128, True, "bfloat16"),
    (2, 8, 4, 300, 128, True, "bfloat16", "bhsd"),
    (1, 4, 2, 129, 64, True, "bfloat16"),
    (1, 16, 8, 2048, 64, True, "bfloat16"),
    (1, 4, 2, 100, 32, True, "bfloat16"),
    (2, 4, 4, 37, 16, True, "bfloat16"),
    (1, 4, 2, 1024, 128, True, "float32"),
    (1, 4, 2, 100, 32, True, "float32"),
    (1, 4, 2, 100, 32, False, "float32"),
    (2, 4, 4, 37, 16, True, "float32"),
)
# ViT's attention (non-causal, H == Hkv): (B, H, S, D, dtype, timed).
# vit_s16_proxy at its 224/16 geometry (S 197) at the vision phase's batch,
# at the allreduce example's 28/7 mnist geometry (S 17), and vit_tiny's
# D 16 in f32 at 32/4 (S 65) and 28/7. The timed cases also run twice and
# must agree bit for bit.
VIT_FLASH_CASES = ((64, 6, 197, 64, "bfloat16", True),
                   (64, 6, 17, 64, "bfloat16", True),
                   (8, 4, 65, 16, "float32", False),
                   (8, 4, 17, 16, "float32", False))
# ViT's RMSNorm rows: every token of vit_s16_proxy's batch (64 x 197) and
# the CLS rows the final norm takes (64), at D 384
VIT_RMS_CASES = ((64 * 197, 384), (64, 384))
# the bf16 flash kernels' symbols, by source, whose SASS must hold HGMMA
# (wgmma)
TC_KERNELS = {"flash_fwd.cu": ("flash_fwd_tc",),
              "flash_bwd.cu": ("flash_bwd_dq_tc", "flash_bwd_dkv_tc")}
TRAIN_CONFIG = "llama3_1b_proxy"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 4096, 5
# peak device memory the train phase may reach, GiB: 12.31 GiB measured
# (PERF.md: weights, grads and AdamW moments 9.1 GB, saved block inputs and
# flash out/lse 2.2 GB, one block's replay and backward), which the flash
# backward kernels must not grow: they allocate no scratch
TRAIN_PEAK_GIB = 12.5
# the ckpt phase: run A's steps (run B resumes to twice as many), the
# copies of the state its directory must hold at once (B's pinned step 2,
# its last commit and the next step's .tmp), the serve-from-checkpoint
# prompts (two of one length, one slot, a budget of exactly prompt + new
# tokens: the engine then runs `generate`'s shapes), and the steps with
# f32 master weights
CKPT_STEPS = 2
CKPT_DISK_COPIES = 3
CKPT_PROMPT, CKPT_NEW = 64, 8
MASTER_STEPS = 3
# peak device memory with f32 master weights, GiB: 23.53 GiB measured
# (PERF.md: bf16 params, f32 masters and f32 AdamW moments 14.8 GiB, then
# the train phase's activations and bf16 grads, and the f32 gradients of
# the update)
MASTER_PEAK_GIB = 24.0
PROMPT_LENS = (1, 17, 128, 512, 513, 1000, 1500, 1900)
MAX_NEW = 16
N_STREAMED = 2
# K5 at llama3_8b's decode products, (label, K, N, LM head: f32 out), each
# at M 1 and 4 rows (4: the serving slots); wq and wo, wk and wv, w_gate
# and w_up share their shapes. The timed summary is w_gate/w_up at M 4.
INT8_CASES = (("wq/wo", 4096, 4096, False), ("wk/wv", 4096, 1024, False),
              ("w_gate/w_up", 4096, 14336, False),
              ("w_down", 14336, 4096, False), ("output", 4096, 128256, True))
INT8_ROWS = (1, 4)
INT8_SUMMARY = "w_gate/w_up M4"
# mixtral_proxy's int8 decode products at its 4 slots, timed: the
# attention products and the LM head, then (label, E, C, K, N) its expert
# banks, one K5 launch a bank (an expert's queue holds 4 rows at no-drop
# capacity; we_gate and we_up share their shape)
INT8_MOE_CASES = (("mixtral wq/wo", 2048, 2048, False),
                  ("mixtral wk/wv", 2048, 1024, False),
                  ("mixtral output", 2048, 32000, True))
INT8_BANK_CASES = (("mixtral we_gate/we_up", 8, 4, 2048, 4096),
                   ("mixtral we_down", 8, 4, 4096, 2048))
# held and not timed: banks of one expert, of 16 rows (two row blocks), of
# an odd count and in f32 (label, E, C, K, N, dtype)
INT8_BANK_EXTRA = (("bank E1", 1, 4, 2048, 4096, "bfloat16"),
                   ("bank C16", 8, 16, 2048, 4096, "bfloat16"),
                   ("bank E3 C5", 3, 5, 4096, 1024, "bfloat16"),
                   ("tiny bank", 3, 2, 64, 128, "float32"))
# held and not timed: row blocks past one (M 5: a partial block of 8;
# M 16: two) in bf16, and the tiny f32 path's products in f32
INT8_EXTRA = (("wk/wv", 4096, 1024, False, 5, "bfloat16"),
              ("wk/wv", 4096, 1024, False, 16, "bfloat16"),
              ("output", 4096, 128256, True, 16, "bfloat16"),
              ("wk/wv", 4096, 1024, False, 4, "float32"),
              ("tiny w_gate", 64, 128, False, 3, "float32"),
              ("tiny output", 64, 256, True, 1, "float32"))
# K6 at the decode step's shapes, (label, B, H, Hkv, budget S, D, dtype,
# lengths, timed iterations): "full" puts every row at the budget's last
# position, "mixed" at seeded lognormal lengths (median
# DECODE_ATTN_MEDIAN, sigma 0.8, as the benchmark's decode cell draws its
# prompts) within the budget, a tuple gives the positions (the first row
# and the last budget row among them). Mistral 7B's 32 slots at budget
# 3072 (the benchmark's decode cell; the mixed case is the summary),
# Mixtral's 8 slots at 4112, one row at 4096, bench_350m's D64; held and
# not timed: llama3_1b_proxy's group of 2 at the quant phase's positions,
# a group of 1, a group of 8 in f32, tiny's f32 D16 and 300 rows (two
# launches: K6 takes MAX_BATCH rows a launch)
DECODE_ATTN_CASES = (
    ("mistral B32 full", 32, 32, 8, 3072, 128, "bfloat16", "full", 50),
    ("mistral B32 mixed", 32, 32, 8, 3072, 128, "bfloat16", "mixed", 50),
    ("mixtral B8", 8, 32, 8, 4112, 128, "bfloat16", "mixed", 50),
    ("B1 4096", 1, 32, 8, 4096, 128, "bfloat16", "full", 50),
    ("bench_350m D64", 32, 16, 8, 2048, 64, "bfloat16", "mixed", 50),
    ("llama3_1b_proxy", 4, 16, 8, 2048, 128, "bfloat16",
     (1900, 700, 300, 20), 0),
    ("group 1", 4, 8, 8, 1000, 128, "bfloat16", (0, 999, 128, 517), 0),
    ("group 8 f32", 2, 16, 2, 700, 64, "float32", (0, 699), 0),
    ("tiny f32 D16", 4, 4, 2, 128, 16, "float32", (0, 127, 5, 64), 0),
    ("300 rows", 300, 16, 8, 512, 64, "bfloat16", "mixed", 0),
)
DECODE_ATTN_MEDIAN = 900
DECODE_ATTN_SUMMARY = "mistral B32 mixed"
# the quant phase: the normalized RMSE of int8 logits against bf16's
# (tests/test_quant.py:55-113), its prompts (B, P), and its decode step's
# slots and positions (the profile phase's)
QUANT_NRMSE = 0.05
QUANT_PROMPTS = (2, 128)
DECODE_SLOTS, DECODE_BUDGET = 4, 2048
DECODE_POS = (1900, 700, 300, 20)
# the kvcache phase: a shared 1024-token prefix (64 pages of 16) and 8
# distinct suffixes
KV_PREFIX, KV_PAGE = 1024, 16
KV_SUFFIXES = (5, 16, 40, 63, 77, 100, 128, 200)
# the orch phase: the train phase's model and batch on a token shard of
# ORCH_SHARD_TOKENS random tokens below the vocab, ORCH_STEPS steps with a
# held-out eval every ORCH_EVAL_EVERY; then the serve phase's burst on
# `python -m tony_tpu_torch.serve`, reports off and on, interleaved
ORCH_STEPS, ORCH_EVAL_EVERY = 8, 4
ORCH_SHARD_TOKENS = 8_000_000
ORCH_SERVE_RUNS = ("off", "on", "off", "on")
# how long a server subprocess may take to print SERVING_UP, seconds
ORCH_SERVER_UP_S = 300.0
# the train phase's median step interval, for the orch phase to compare
TRAIN_INTERVAL: dict = {}
# a llama3_1b_proxy checkpoint the ckpt phase wrote, kept for the long
# phase's serving submitter: {"root": its temporary root, "dir": it}
KEPT_CKPT: dict = {}
# the moe phase: mixtral_proxy at full width and depth, bf16. Served at
# no-drop capacity (the entry point's), the serve phase's burst; its
# prefill's last logits held to moe_forward's at MOE_FORWARD_PROMPT
# tokens; greedy streams held to `generate` at its own shapes (one slot,
# a budget of prompt + new tokens) for MOE_EXACT_PROMPTS; trained at
# MOE_TRAIN_BATCH x TRAIN_SEQ with the preset's capacity factor 1.25, then
# two fresh runs of MOE_REPEAT_STEPS steps that must agree bit for bit
MOE_CONFIG = "mixtral_proxy"
MOE_FORWARD_PROMPT = 513
MOE_EXACT_PROMPTS = (128, 513)
MOE_TRAIN_BATCH = 4
MOE_REPEAT_STEPS = 2
# peak device memory the MoE training may reach, GiB: bf16 params, grads
# and AdamW moments of 3.554 B parameters are 26.5 GiB; save_flash keeps
# 2.1 GiB of block inputs and flash out/lse; one block's replay and
# backward at E * C = 40960 expert rows holds a few GiB more
MOE_TRAIN_PEAK_GIB = 40.0


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, message: str) -> None:
    if not cond:
        raise SmokeFailure(message)


def log(message: str) -> None:
    print(message, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30, check=True)
    return out.stdout.strip().splitlines()[0]


def card_peaks(name: str) -> tuple[float, float, float]:
    """(bytes/s, bf16 FLOP/s, f32 FLOP/s) from the port's table
    (`tony_tpu_torch/device.py`)."""
    from tony_tpu_torch.device import card_peaks as table
    peaks = table(name)
    if peaks is None:
        raise SmokeFailure(f"no peak rates known for {name!r}")
    return peaks


def _device_us(event) -> float:
    return event.self_device_time_total


def device_events(prof) -> list:
    """A profile's device-side events (kernels, copies, fills): the host
    ops that launched them carry the same time again. The device-side
    mirrors of `record_function` ranges (train_step, Optimizer.step) span
    other kernels and are left out."""
    events = prof.key_averages()
    annotations = {e.key for e in events
                   if getattr(e, "is_user_annotation", False)}
    return [e for e in events if str(e.device_type).endswith("CUDA")
            and e.key not in annotations
            and not getattr(e, "is_user_annotation", False)]


def log_top(kernels: list, n: int) -> None:
    """The profile's `n` largest device ops, then each of the port's own
    kernels (by the templates of csrc/: flash_*, rmsnorm_*, w8a16,
    decode_attention) that
    is not among them."""
    ranked = sorted(kernels, key=_device_us, reverse=True)
    for e in ranked[:n]:
        log(f"profile:   {_device_us(e) / 1e3:8.3f} ms  x{e.count:<5d} "
            f"{e.key[:90]}")
    for e in ranked[n:]:
        if re.search(r"\b(flash_\w+|rmsnorm_\w+|w8a16|decode_attention)<",
                     e.key):
            log(f"profile:   {_device_us(e) / 1e3:8.3f} ms  x{e.count:<5d} "
                f"{e.key[:90]} (a port kernel)")


def _events_ms(fn, iters: int, sleep_cycles: int = 0) -> float:
    """CUDA-event time of `iters` back-to-back fn() calls, over `iters`,
    optionally queued behind a sleep kernel of `sleep_cycles`."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if sleep_cycles:
        torch.cuda._sleep(sleep_cycles)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timed(fn, iters: int, warmup: int = 3) -> tuple[float, float]:
    """(device_ms, call_ms) of one fn() call, after `warmup` calls.
    call_ms: CUDA-event time per call as the host issues them; where the
    device outruns the host it measures the host's launch cost. device_ms:
    the same calls queued behind a sleep kernel that lasts twice as long as
    issuing them took, so the device runs them back to back: the device
    time per call, the host's cost hidden."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    call_ms = _events_ms(fn, iters)
    return _events_ms(fn, iters, _sleep_cycles(call_ms * iters)), call_ms


def _sleep_cycles(host_ms: float) -> int:
    """Cycles of a sleep kernel that outlasts twice `host_ms` of host
    launch time (and 5 ms at least)."""
    import torch
    cycles_per_ms = 1e6 / _events_ms(lambda: torch.cuda._sleep(1_000_000), 1)
    return int(cycles_per_ms * max(5.0, 2 * host_ms))


def timed_cold(fn, iters: int, flush) -> float:
    """Device ms of one fn() call that finds the L2 cold: before each call,
    outside the CUDA events that bracket fn() alone, `flush` (twice the
    L2) is written and then read back, so fn()'s inputs are evicted and the
    write-back of the flush's own dirty lines is done before fn() starts
    (written alone, it would land inside the timed call). The calls queue
    behind a sleep kernel, so the host's cost stays hidden."""
    import torch
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]

    def run(sleep_cycles: int) -> float:
        torch.cuda.synchronize()
        if sleep_cycles:
            torch.cuda._sleep(sleep_cycles)
        t0 = time.monotonic()
        for start, end in pairs:
            flush.zero_().sum()
            start.record()
            fn()
            end.record()
        host_ms = (time.monotonic() - t0) * 1e3
        torch.cuda.synchronize()
        return host_ms

    host_ms = run(0)                         # warm-up, and the host's pace
    run(_sleep_cycles(host_ms))
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def max_err(got, want, tol: float) -> tuple[float, bool]:
    """max |got - want| and whether |got - want| <= tol + tol * |want|
    everywhere (numpy's assert_allclose with atol = rtol = tol)."""
    import torch
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    ok = bool(torch.all(diff <= tol + tol * w.abs()).item()) and \
        bool(torch.isfinite(g).all().item())
    return float(diff.max().item()), ok


def norm_err(got, want) -> tuple[float, float, tuple[int, ...]]:
    """(||got - want|| / ||want||, the worst row's ||got_r - want_r|| /
    (||want_r|| + 1e-3 * rms_r ||want_r||), that row's index over the
    leading dims, e.g. (b, h, s)), rows along the last dim. The floor keeps
    rows whose exact value is 0 (causal dQ of row 0) from dividing
    rounding noise by nothing."""
    g = got.float().reshape(-1, got.shape[-1])
    w = want.float().reshape(-1, want.shape[-1])
    diff = (g - w).norm(dim=-1)
    rows = w.norm(dim=-1)
    floor = 1e-3 * rows.square().mean().sqrt()
    total = float(diff.norm() / rows.norm().clamp_min(1e-30))
    ratio = diff / (rows + floor).clamp_min(1e-30)
    flat = int(ratio.argmax())
    where = []
    for n in reversed(got.shape[:-1]):
        where.append(flat % n)
        flat //= n
    return total, float(ratio.max()), tuple(reversed(where))


def hold(got, want, tol: float, by_norm: bool, name: str = "") -> dict:
    """The case's verdict: elementwise within `tol`, and with `by_norm` the
    norm-wise errors within NORM_TOL (and where the worst row is, as
    `name` (b, h, s))."""
    err, ok = max_err(got, want, tol)
    r = {"max_abs_err": err, "ok": ok}
    if by_norm:
        total, row, where = norm_err(got, want)
        r.update(norm_err=total, row_err=row,
                 worst_row=f"{name} {where}".strip(),
                 ok=ok and total <= NORM_TOL and row <= NORM_TOL)
    return r


def merge(*held: dict) -> dict:
    """One verdict for several outputs of a kernel: the worst of each
    error (and the worst row's place), ok only if every output is."""
    r = {"ok": all(h["ok"] for h in held)}
    for key in ("max_abs_err", "norm_err", "row_err"):
        if any(key in h for h in held):
            r[key] = max(h.get(key, 0.0) for h in held)
    if "row_err" in r:
        r["worst_row"] = max((h for h in held if "row_err" in h),
                             key=lambda h: h["row_err"])["worst_row"]
    return r


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------

def phase_build() -> None:
    from tony_tpu_torch.ops import (  # noqa: F401 (register)
        attention, decode_attention, int8_matmul, rmsnorm,
    )
    from tony_tpu_torch.ops import cuda_lib

    sources = sorted({k.source for k in cuda_lib.KERNELS.values()})
    version = subprocess.run([cuda_lib.find_nvcc(), "--version"],
                             capture_output=True, text=True, timeout=60,
                             check=True).stdout.strip().splitlines()
    log(f"build: {version[-1] if version else 'nvcc version unknown'}")
    t0 = time.monotonic()
    seconds = cuda_lib.build(sources)
    log(f"build: {len(seconds)} of {len(sources)} sources compiled in "
        f"{time.monotonic() - t0:.1f} s wall "
        + ", ".join(f"{s} {t:.1f} s" for s, t in seconds.items()))
    for source in sources:
        entry = ""
        for line in cuda_lib.build_log(source).splitlines():
            if "Compiling entry function" in line:
                entry = kernel_name(line.split("'")[1]) if "'" in line else ""
            elif "registers" in line or "spill" in line or "error" in line:
                log(f"  nvcc {source} {entry}: {line.strip()}")
        cuda_lib.load(source)
    for source, tc_kernels in TC_KERNELS.items():
        counts = hgmma_counts(cuda_lib.library_path(source))
        for kernel in tc_kernels:
            found = {sym: n for sym, n in counts.items() if kernel in sym}
            for sym, n in sorted(found.items()):
                log(f"build: {kernel_name(sym)}: {n} HGMMA instructions")
            check(found and all(n > 0 for n in found.values()),
                  f"no HGMMA (wgmma) in the SASS of {kernel}: {found}")


def kernel_name(symbol: str) -> str:
    """A mangled kernel symbol as `name<template arguments>`, e.g.
    `flash_bwd_dq_tc<Li128>`: the source name is the one whose length
    prefix leads to a template argument list."""
    for m in re.finditer(r"\d+", symbol):
        digits, end = m.group(), m.end()
        for k in range(1, len(digits) + 1):
            length = int(digits[-k:])
            name, rest = symbol[end:end + length], symbol[end + length:]
            if name.isidentifier() and rest.startswith("I") and "E" in rest:
                return f"{name}<{rest[1:rest.index('E')]}>"
    return symbol[-60:]


def hgmma_counts(library) -> dict[str, int]:
    """{kernel symbol: HGMMA instructions in its SASS}, from cuobjdump."""
    from tony_tpu_torch.ops import cuda_lib
    tool = Path(cuda_lib.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(library)],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    counts: dict[str, int] = {}
    current = None
    for line in sass.splitlines():
        if "Function :" in line:
            current = line.split("Function :")[1].strip()
            counts[current] = 0
        elif current is not None and "HGMMA" in line:
            counts[current] += 1
    return counts


# ---------------------------------------------------------------------------
# phase 1b: the kernel build cache under $TONY_JAX_CACHE_DIR
# ---------------------------------------------------------------------------

# a task start as far as its kernels: the cache applied, every source built
# (or found) and loaded; prints what this process compiled and its wall
CACHE_PROBE = """
import json, sys, time
t0 = time.monotonic()
from tony_tpu_torch.ops import (
    attention, cuda_lib, decode_attention, int8_matmul, rmsnorm)
from tony_tpu_torch.utils.compilecache import maybe_enable_compile_cache
applied = maybe_enable_compile_cache()
sources = sorted({k.source for k in cuda_lib.KERNELS.values()})
compiled = cuda_lib.build(sources)
for source in sources:
    cuda_lib.load(source)
print(json.dumps({"dir": applied, "compiled": sorted(compiled),
                  "loaded": sources, "wall_s": time.monotonic() - t0}))
"""


def _listing(d) -> set[str]:
    return set(os.listdir(d)) if os.path.isdir(d) else set()


def phase_cache(smi: str) -> None:
    """Two task starts together on an empty $TONY_JAX_CACHE_DIR compile
    each source once between them (the build lock), a third compiles
    nothing and loads all of them, and `python -m tony_tpu_torch.train
    --config tiny --steps 2` under the same variable compiles nothing and
    writes no library into the package's `_build/`. Prints the cold and
    warm walls and the seconds a warm cache saves a task start."""
    from tony_tpu_torch.ops import cuda_lib
    from tony_tpu_torch.utils.compilecache import KERNELS_SUBDIR

    repo = str(Path(__file__).resolve().parent)
    root = tempfile.mkdtemp(prefix="chip-smoke-cache-")
    env = dict(os.environ, PYTHONPATH=repo, TONY_JAX_CACHE_DIR=root)
    kernels_dir = os.path.join(root, KERNELS_SUBDIR)
    default_before = _listing(cuda_lib.DEFAULT_BUILD_DIR)
    cmd = [sys.executable, "-c", CACHE_PROBE]
    try:
        t0 = time.monotonic()
        procs = [subprocess.Popen(cmd, cwd=repo, env=env, text=True,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE) for _ in range(2)]
        outs = [p.communicate(timeout=600) for p in procs]
        cold_s = time.monotonic() - t0
        for p, (out, err) in zip(procs, outs):
            check(p.returncode == 0, f"cache: a cold start exited "
                                     f"{p.returncode}: {err[-2000:]}")
        cold = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
        sources = cold[0]["loaded"]
        compiled = sorted(cold[0]["compiled"] + cold[1]["compiled"])
        log(f"cache: two task starts together on an empty cache: compiled "
            f"{cold[0]['compiled']} and {cold[1]['compiled']}, walls "
            f"{cold[0]['wall_s']:.2f} / {cold[1]['wall_s']:.2f} s in the "
            f"process ({cold_s:.2f} s from spawn to exit); {smi}")
        check(compiled == sources,
              f"cache: compiled {compiled} between the two, not each of "
              f"{sources} once")
        check(all(c["dir"] == str(Path(kernels_dir).resolve())
                  for c in cold), f"cache: build dirs {cold}")
        t0 = time.monotonic()
        warm = subprocess.run(cmd, cwd=repo, env=env, text=True,
                              capture_output=True, timeout=600)
        warm_s = time.monotonic() - t0
        check(warm.returncode == 0,
              f"cache: the warm start exited {warm.returncode}: "
              f"{warm.stderr[-2000:]}")
        w = json.loads(warm.stdout.strip().splitlines()[-1])
        check(w["compiled"] == [] and w["loaded"] == sources,
              f"cache: the warm start compiled {w['compiled']}, loaded "
              f"{w['loaded']}")
        cold_wall = max(c["wall_s"] for c in cold)
        log(f"cache: a third start compiled nothing and loaded {sources} "
            f"in {w['wall_s']:.2f} s ({warm_s:.2f} s from spawn to exit); "
            f"a warm cache saves {cold_wall - w['wall_s']:.2f} s per task "
            f"start ({cold_wall:.2f} s cold); {smi}")

        cache_before = _listing(kernels_dir)
        out = subprocess.run(
            [sys.executable, "-m", "tony_tpu_torch.train", "--config",
             "tiny", "--steps", "2"], cwd=repo, env=env, text=True,
            capture_output=True, timeout=600)
        last = out.stdout.strip().splitlines()[-1] if out.stdout.strip() \
            else ""
        check(out.returncode == 0 and last.startswith("final loss "),
              f"cache: the tiny trainer exited {out.returncode}: "
              f"{out.stderr[-2000:]}")
        new_cache = _listing(kernels_dir) - cache_before
        new_default = _listing(cuda_lib.DEFAULT_BUILD_DIR) - default_before
        log(f"cache: python -m tony_tpu_torch.train --config tiny --steps 2 "
            f"under the cache: {last!r}; new files in the cache "
            f"{sorted(new_cache)}, in _build/ {sorted(new_default)}")
        check("persistent kernel build cache at" in out.stderr
              and "nvcc compiled" not in out.stderr,
              f"cache: the trainer did not load from the cache: "
              f"{out.stderr[-2000:]}")
        check(not any(n.endswith(".so") for n in new_cache | new_default),
              f"cache: the trainer wrote libraries {new_cache} "
              f"{new_default}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _flash_fwd_times(q, k, v, causal: bool, scale: float, peaks,
                     iters: int, plain_iters: int, label: str) -> dict:
    """K1's device ms (and call ms) beside `blockwise_forward`'s, SDPA's
    forward on the same q, k, v and the bound, with its TFLOP/s and share
    of the bound logged."""
    import torch
    import torch.nn.functional as F

    from tony_tpu_torch.ops.attention import (
        blockwise_forward, flash_fwd_cuda,
    )
    b, h, s, d = q.shape
    hk = k.shape[1]
    ms, call_ms = timed(lambda: flash_fwd_cuda(q, k, v, causal, scale),
                        iters)
    plain_ms, _ = timed(lambda: blockwise_forward(q, k, v, causal, scale),
                        plain_iters, warmup=1)
    library_ms, _ = timed(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, scale=scale, enable_gqa=True), iters)
    bw, bf16_peak, f32_peak = peaks
    itemsize = q.element_size()
    nbytes = 2 * b * h * s * d * itemsize + 2 * b * hk * s * d * itemsize \
        + 4 * b * h * s
    # two products of 2 * D per (query, key) pair; causal keeps half
    flops = 4.0 * b * h * (s * s / 2 if causal else s * s) * d
    peak = bf16_peak if q.dtype == torch.bfloat16 else f32_peak
    t_bytes, t_ops = nbytes / bw * 1e3, flops / peak * 1e3
    bound = max(t_bytes, t_ops)
    log(f"kernel flash_fwd {label}: {flops / ms / 1e9:.1f} TFLOP/s, "
        f"{bound / ms * 100:.1f}% of its bound; SDPA forward "
        f"{library_ms:.4f} ms")
    return {"ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _flash_case(b: int, h: int, hk: int, s: int, d: int, causal: bool,
                dtype, peaks, iters: int) -> dict:
    """K1 against `blockwise_forward` on the same inputs; timed when
    `iters` is not 0."""
    import torch

    from tony_tpu_torch.ops.attention import (
        blockwise_forward, flash_fwd_cuda,
    )
    scale = d ** -0.5
    g = torch.Generator(device="cuda").manual_seed(s + 1000 * d + h)
    # the layout qkv_proj hands the kernel: (B, S, H, D) products viewed
    # as (B, H, S, D)
    q = torch.randn((b, s, h, d), generator=g, device="cuda").to(
        dtype).transpose(1, 2)
    k = torch.randn((b, s, hk, d), generator=g, device="cuda").to(
        dtype).transpose(1, 2)
    v = torch.randn((b, s, hk, d), generator=g, device="cuda").to(
        dtype).transpose(1, 2)
    out, lse = flash_fwd_cuda(q, k, v, causal, scale)
    ref_out, ref_lse = blockwise_forward(q, k, v, causal, scale)
    torch.cuda.synchronize()
    dtype_name = str(dtype).split(".")[-1]
    tol = TOL[dtype_name]
    shape = f"B{b} H{h} Hkv{hk} S{s} D{d}{' causal' if causal else ''}"
    r = {"shape": shape, "dtype": dtype_name, "tol": tol,
         "summary": (b, h, hk, s, d, causal) == (1, 32, 8, FLASH_SEQS[-1],
                                                 128, True),
         **merge(hold(out, ref_out, tol, dtype == torch.bfloat16, "out"),
                 hold(lse, ref_lse, tol, False))}
    if iters:
        r.update(_flash_fwd_times(q, k, v, causal, scale, peaks, iters,
                                  max(1, iters // 4), f"{dtype_name} {shape}"))
    return r


def _rms_case(rows: int, d: int, dtype, peaks, iters: int, flush) -> dict:
    import torch
    import torch.nn.functional as F

    from tony_tpu_torch.ops.rmsnorm import rms_norm_cuda, rms_norm_reference
    eps = 1e-5
    g = torch.Generator(device="cuda").manual_seed(rows + d)
    x = torch.randn((rows, d), generator=g, device="cuda").to(dtype)
    w = torch.randn((d,), generator=g, device="cuda") * 0.1 + 1.0
    out = rms_norm_cuda(x, w, eps)
    ref = rms_norm_reference(x, w, eps)
    torch.cuda.synchronize()
    tol = TOL[str(dtype).split(".")[-1]]
    err, ok = max_err(out, ref, tol)
    ms, call_ms = timed(lambda: rms_norm_cuda(x, w, eps), iters)
    plain_ms, _ = timed(lambda: rms_norm_reference(x, w, eps), iters)
    w_x = w.to(dtype)
    library_ms, _ = timed(lambda: F.rms_norm(x, (d,), w_x, eps), iters)
    # as the path finds x between layers: not in the L2
    cold_ms = timed_cold(lambda: rms_norm_cuda(x, w, eps), iters, flush)
    cold_library_ms = timed_cold(lambda: F.rms_norm(x, (d,), w_x, eps),
                                 iters, flush)
    bw = peaks[0]
    nbytes = 2 * rows * d * x.element_size() + 4 * d
    # the kernel's dispatch on shape: 16-byte vectors where a row is a
    # whole number of them (x is aligned here)
    path = "vector" if d * x.element_size() % 16 == 0 else "scalar"
    return {"shape": f"rows{rows} D{d} ({path})",
            "dtype": str(dtype).split(".")[-1],
            "max_abs_err": err, "ok": ok, "tol": tol,
            "summary": (rows, d) == RMS_SUMMARY, "ms": ms,
            "call_ms": call_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "cold_ms": cold_ms, "cold_library_ms": cold_library_ms,
            "bound_ms": nbytes / bw * 1e3, "bound_by": "bytes"}


def _flash_bwd_case(b: int, h: int, hk: int, s: int, d: int, causal: bool,
                    dtype_name: str, layout: str, peaks, timed_case: bool
                    ) -> tuple[dict, dict, dict | None]:
    """K2 and K3 against `blockwise_backward` on the same (out, lse) and
    dO, in the layouts the training path gives them; at the timed case
    (the training shape) also K1's (out, lse) against `blockwise_forward`,
    K1, K2 and K3 run again and compared bit for bit, and their times
    beside the plain versions', SDPA's forward and SDPA's backward.
    Returns the K2 entry, the K3 entry and the K1 entry or None."""
    import torch
    import torch.nn.functional as F

    from tony_tpu_torch.ops.attention import (
        attention_delta, blockwise_backward, blockwise_forward,
        flash_bwd_dkv_cuda, flash_bwd_dq_cuda, flash_fwd_cuda,
    )
    dtype = getattr(torch, dtype_name)
    scale = d ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(s + h)

    def operand(heads):
        x = torch.randn((b, s, heads, d), generator=gen,
                        device="cuda").to(dtype).transpose(1, 2)
        return x.contiguous() if layout == "bhsd" else x

    q, k, v, dout = operand(h), operand(hk), operand(hk), operand(h)
    out, lse = flash_fwd_cuda(q, k, v, causal, scale)
    delta = attention_delta(dout, out)
    dq = flash_bwd_dq_cuda(q, k, v, dout, lse, delta, causal, scale)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, dout, lse, delta, causal, scale)
    want = blockwise_backward(q, k, v, out, lse, dout, causal, scale)
    torch.cuda.synchronize()
    tol = BWD_TOL[dtype_name]
    bf16 = dtype == torch.bfloat16
    held = [hold(got, w, tol, bf16, name)
            for got, w, name in zip((dq, dk, dv), want, ("dq", "dk", "dv"))]
    shape = (f"B{b} H{h} Hkv{hk} S{s} D{d}"
             f"{' causal' if causal else ''}"
             f"{' bhsd' if layout == 'bhsd' else ''}")
    entries = [{"shape": shape, "dtype": dtype_name, "tol": tol,
                "summary": timed_case, **verdict}
               for verdict in (held[0], merge(held[1], held[2]))]
    del want, held
    if not timed_case:
        return entries[0], entries[1], None
    ref_out, ref_lse = blockwise_forward(q, k, v, causal, scale)
    fwd = {"shape": shape, "dtype": dtype_name, "tol": TOL[dtype_name],
           "summary": False,
           **merge(hold(out, ref_out, TOL[dtype_name], bf16, "out"),
                   hold(lse, ref_lse, LSE_TOL, False))}
    del ref_out, ref_lse
    # the kernels are deterministic: no atomics, a fixed order of sums
    again = {"out": out, "lse": lse, "dq": dq, "dk": dk, "dv": dv}
    again_out, again_lse = flash_fwd_cuda(q, k, v, causal, scale)
    again_dq = flash_bwd_dq_cuda(q, k, v, dout, lse, delta, causal, scale)
    again_dk, again_dv = flash_bwd_dkv_cuda(q, k, v, dout, lse, delta,
                                            causal, scale)
    torch.cuda.synchronize()
    for name, b_ in zip(again, (again_out, again_lse, again_dq, again_dk,
                                again_dv)):
        same = torch.equal(again[name], b_)
        log(f"kernel flash {shape}: {name} bitwise equal over two calls: "
            f"{same}")
        check(same, f"flash {name} differs between two calls")
    del again, again_out, again_lse, again_dq, again_dk, again_dv
    iters = 5
    fwd.update(_flash_fwd_times(q, k, v, causal, scale, peaks, iters, 1,
                                f"{dtype_name} {shape}"))
    ms_dq, call_dq = timed(lambda: flash_bwd_dq_cuda(
        q, k, v, dout, lse, delta, causal, scale), iters)
    ms_dkv, call_dkv = timed(lambda: flash_bwd_dkv_cuda(
        q, k, v, dout, lse, delta, causal, scale), iters)
    plain_ms, _ = timed(lambda: blockwise_backward(
        q, k, v, out, lse, dout, causal, scale), 2, warmup=1)
    # the library yardstick: SDPA's backward on the same q, k, v and dO
    # (one number for K2 and K3 together)
    ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(
        ql, kl, vl, is_causal=causal, scale=scale, enable_gqa=True)
    library_ms, _ = timed(lambda: torch.autograd.grad(
        lib_out, (ql, kl, vl), dout, retain_graph=True), iters)
    library_call = lib_out.grad_fn.name()
    bw, bf16_peak, f32_peak = peaks
    peak = bf16_peak if dtype == torch.bfloat16 else f32_peak
    item = q.element_size()
    # each causal product covers half the S x S pairs
    pairs = s * s / 2 if causal else s * s
    product = 2.0 * b * h * pairs * d
    in_bytes = (2 * b * h * s * d + 2 * b * hk * s * d) * item \
        + 2 * 4 * b * h * s
    for name, entry, ms, call_ms, n_products, out_bytes in (
            ("flash_bwd_dq", entries[0], ms_dq, call_dq, 3,
             b * h * s * d * item),
            ("flash_bwd_dkv", entries[1], ms_dkv, call_dkv, 4,
             2 * b * hk * s * d * item)):
        t_ops = n_products * product / peak * 1e3
        t_bytes = (in_bytes + out_bytes) / bw * 1e3
        log(f"kernel {name} {shape}: "
            f"{n_products * product / ms / 1e9:.1f} TFLOP/s, "
            f"{max(t_ops, t_bytes) / ms * 100:.1f}% of its bound")
        entry.update({"ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
                      "library_ms": library_ms,
                      "library_call": library_call,
                      "bound_ms": max(t_ops, t_bytes),
                      "bound_by": "operations" if t_ops >= t_bytes
                      else "bytes"})
    return entries[0], entries[1], fwd


def _k5_other() -> None:
    """One K5 launch of a shape no case has (M 3, K 1024, N 2048: split
    25 ways in groups of 5, so its counters are used), between a case's
    two calls: a counter that a launch left non-zero would make the
    second disagree."""
    import torch

    from tony_tpu_torch.models.quant import quantize
    from tony_tpu_torch.ops.int8_matmul import int8_matmul_cuda
    g = torch.Generator(device="cuda").manual_seed(5)
    t = quantize(torch.randn((1024, 2048), generator=g, device="cuda"))
    int8_matmul_cuda(torch.randn((3, 1024), generator=g, device="cuda"), t)


def _int8_library(r: dict, x, t, out_f32: bool, iters: int) -> None:
    """K5's library yardsticks on the same inputs: torch.matmul on the
    weight dequantized to bf16 beforehand, and torch._weight_int8pack_mm
    (an (N, K) int8 weight, per-channel bf16 scales: the same function)
    where it launches on the card; `library_ms` is the latter when it
    does, else the former (the error is kept)."""
    import torch

    from tony_tpu_torch.models.quant import dequantize
    from tony_tpu_torch.ops.xent import matmul_f32
    w = dequantize(t)
    r["matmul_bf16_ms"], _ = timed(
        (lambda: matmul_f32(x, w)) if out_f32 else (lambda: x @ w), iters)
    r["library_ms"] = r["matmul_bf16_ms"]
    r["library_call"] = "torch.matmul on the dequantized bf16 weight"
    q_nk = t["int8"].t().contiguous()
    s_n = t["scale"].reshape(-1).to(torch.bfloat16)
    xb = x.to(torch.bfloat16)
    try:
        r["int8pack_ms"], _ = timed(
            lambda: torch._weight_int8pack_mm(xb, q_nk, s_n), iters)
    except Exception as e:  # the card's torch may not have it for CUDA
        r["int8pack_error"] = f"{type(e).__name__}: {e}"[:160]
        log(f"kernel int8_matmul: torch._weight_int8pack_mm does not run "
            f"here ({r['int8pack_error']}); library_ms stays torch.matmul "
            f"on the bf16 weight")
    else:
        r["library_ms"] = r["int8pack_ms"]
        r["library_call"] = (f"torch._weight_int8pack_mm (torch.matmul on "
                             f"the bf16 weight {r['matmul_bf16_ms']:.4f})")


def _int8_case(label: str, k: int, n: int, out_f32: bool, m: int,
               dtype_name: str, peaks, iters: int) -> dict:
    """K5 against its plain version on one random int8 weight (a bf16
    weight quantized on the card) and x; run twice, with a launch of
    another shape between, and compared bit for bit. Timed when `iters`:
    the plain version and the library yardsticks (`_int8_library`)."""
    import torch

    from tony_tpu_torch.models.quant import quantize
    from tony_tpu_torch.ops.int8_matmul import (
        int8_matmul_cuda, int8_matmul_reference, splits_for,
    )
    dtype = getattr(torch, dtype_name)
    g = torch.Generator(device="cuda").manual_seed(7 * k + n + m)
    t = quantize((torch.randn((k, n), generator=g, device="cuda")
                  * k ** -0.5).to(torch.bfloat16))
    x = torch.randn((m, k), generator=g, device="cuda").to(dtype)
    out = int8_matmul_cuda(x, t, out_f32)
    _k5_other()
    again = int8_matmul_cuda(x, t, out_f32)
    ref = int8_matmul_reference(x, t, out_f32)
    torch.cuda.synchronize()
    tol = TOL[dtype_name]
    r = hold(out, ref, tol, by_norm=dtype_name == "bfloat16", name=label)
    r["bitwise"] = bool(torch.equal(out, again))
    r["ok"] = r["ok"] and r["bitwise"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    r.update(shape=f"{label} M{m} K{k} N{n} (splits "
                   f"{splits_for(m, k, n, sms)})",
             dtype=dtype_name, tol=tol, summary=False)
    if iters:
        r["ms"], r["call_ms"] = timed(
            lambda: int8_matmul_cuda(x, t, out_f32), iters)
        r["plain_ms"], _ = timed(
            lambda: int8_matmul_reference(x, t, out_f32), max(3, iters // 10))
        _int8_library(r, x, t, out_f32, iters)
        # each input read once, the output written once; the multiply-adds
        # run on the CUDA cores in f32
        nbytes = (k * n + 4 * n + m * k * x.element_size()
                  + m * n * out.element_size())
        bytes_ms = nbytes / peaks[0] * 1e3
        ops_ms = 2 * m * k * n / peaks[2] * 1e3
        r["bound_ms"] = max(bytes_ms, ops_ms)
        r["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
        r["summary"] = f"{label} M{m}" == INT8_SUMMARY
    del t, x, out, again, ref
    torch.cuda.empty_cache()
    return r


def _int8_bank_case(label: str, e: int, c: int, k: int, n: int,
                    dtype_name: str, peaks, iters: int) -> dict:
    """K5 on a bank of E int8 expert weights, one launch for the bank,
    against the plain version (each expert's plain product, stacked); run
    twice with a launch of another shape between, bit for bit. Timed when
    `iters`: the plain version and torch.bmm on the bank dequantized to
    bf16 beforehand (the library yardstick)."""
    import torch

    from tony_tpu_torch.models.quant import dequantize, quantize
    from tony_tpu_torch.ops.int8_matmul import (
        INT8_MATMUL, int8_bmm_cuda, int8_bmm_reference, splits_for,
    )
    dtype = getattr(torch, dtype_name)
    g = torch.Generator(device="cuda").manual_seed(7 * k + n + c + e)
    t = quantize((torch.randn((e, k, n), generator=g, device="cuda")
                  * k ** -0.5).to(torch.bfloat16))
    x = torch.randn((e, c, k), generator=g, device="cuda").to(dtype)
    before = INT8_MATMUL.launches
    out = int8_bmm_cuda(x, t)
    one_launch = INT8_MATMUL.launches - before == 1
    _k5_other()
    again = int8_bmm_cuda(x, t)
    ref = int8_bmm_reference(x, t)
    torch.cuda.synchronize()
    tol = TOL[dtype_name]
    r = hold(out, ref, tol, by_norm=dtype_name == "bfloat16", name=label)
    r["bitwise"] = bool(torch.equal(out, again))
    r["ok"] = r["ok"] and r["bitwise"]
    check(one_launch, f"int8 bank {label}: not one K5 launch")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    r.update(shape=f"{label} E{e} M{c} K{k} N{n} (splits "
                   f"{splits_for(c, k, n, sms, e)})",
             dtype=dtype_name, tol=tol, summary=False)
    if iters:
        r["ms"], r["call_ms"] = timed(lambda: int8_bmm_cuda(x, t), iters)
        r["plain_ms"], _ = timed(lambda: int8_bmm_reference(x, t),
                                 max(3, iters // 10))
        w = dequantize(t, dtype)
        r["library_ms"], _ = timed(lambda: torch.bmm(x, w), iters)
        r["library_call"] = "torch.bmm on the dequantized bf16 bank"
        nbytes = e * (k * n + 4 * n + c * k * x.element_size()
                      + c * n * out.element_size())
        bytes_ms = nbytes / peaks[0] * 1e3
        ops_ms = 2 * e * c * k * n / peaks[2] * 1e3
        r["bound_ms"] = max(bytes_ms, ops_ms)
        r["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
        del w
    del t, x, out, again, ref
    torch.cuda.empty_cache()
    return r


def _decode_attn_positions(b: int, s: int, lengths) -> list[int]:
    """Each row's position for a DECODE_ATTN_CASES entry."""
    import numpy as np
    if lengths == "full":
        return [s - 1] * b
    if lengths == "mixed":
        rng = np.random.RandomState(b * 7919 + s)
        n = np.exp(np.log(DECODE_ATTN_MEDIAN) + 0.8 * rng.randn(b))
        return [int(x) - 1 for x in np.clip(n, 1, s)]
    return list(lengths)


def _decode_attn_case(label: str, b: int, h: int, hkv: int, s: int, d: int,
                      dtype_name: str, lengths, iters: int, peaks) -> dict:
    """K6 against its plain version on random q, k, v and a 2-layer cache
    of noise, at layer 1: the output, and the cache after the call (the
    written rows) bit for bit; one launch (one each MAX_BATCH rows); run
    twice, bit for bit; one row decoded alone, bit for bit. Timed
    when `iters`: the plain version, and `scaled_dot_product_attention`
    with a boolean mask over the whole budget (attention alone, no RoPE
    or row write; the port never calls it) as the library yardstick. The
    bound: the live K and V rows read, the new rows written, q, k, v and
    the table rows read and the output written, once, at the memory
    rate."""
    import torch
    import torch.nn.functional as F

    from tony_tpu_torch.ops.decode_attention import (
        DECODE_ATTENTION, MAX_BATCH, decode_attention_cuda,
        decode_attention_reference,
    )
    from tony_tpu_torch.ops.rope import rope_frequencies

    dtype = getattr(torch, dtype_name)
    g = torch.Generator(device="cuda").manual_seed(131 * b + s + d)

    def noise(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    pos_list = _decode_attn_positions(b, s, lengths)
    pos = torch.tensor(pos_list, dtype=torch.long, device="cuda")
    q = noise(b, 1, h, d).transpose(1, 2)
    k = noise(b, 1, hkv, d).transpose(1, 2)
    v = noise(b, 1, hkv, d).transpose(1, 2)
    kc, vc = noise(2, b, hkv, s, d), noise(2, b, hkv, s, d)
    cos, sin = rope_frequencies(d, s, 1e6, device=torch.device("cuda"))
    kc_ref, vc_ref = kc.clone(), vc.clone()

    def k6():
        return decode_attention_cuda(q, k, v, kc, vc, 1, cos, sin, pos)

    def plain():
        return decode_attention_reference(q, k, v, kc_ref, vc_ref, 1, cos,
                                          sin, pos)

    before = DECODE_ATTENTION.launches
    out = k6()
    launches = DECODE_ATTENTION.launches - before
    again = k6()
    ref = plain()
    torch.cuda.synchronize()
    tol = TOL[dtype_name]
    r = hold(out, ref.view(out.shape), tol,
             by_norm=dtype_name == "bfloat16", name=label)
    r["bitwise"] = bool(torch.equal(out, again))
    rows = bool(torch.equal(kc, kc_ref) and torch.equal(vc, vc_ref))
    # a row decoded alone gives the batch's bits (the engine's streams are
    # offline generate's)
    j = b // 2
    alone = decode_attention_cuda(
        q[j:j + 1], k[j:j + 1], v[j:j + 1], kc[:, j:j + 1].contiguous(),
        vc[:, j:j + 1].contiguous(), 1, cos, sin, pos[j:j + 1])
    r["alone"] = bool(torch.equal(alone, out[j:j + 1]))
    r["ok"] = r["ok"] and r["bitwise"] and rows and r["alone"]
    check(launches == -(-b // MAX_BATCH),
          f"decode attention {label}: {launches} K6 launches")
    live = sum(p + 1 for p in pos_list)
    r.update(shape=f"{label} B{b} H{h}/{hkv} D{d} S{s} (live rows {live}; "
                   f"cache rows equal {rows}; row {j} alone equal "
                   f"{r['alone']})",
             dtype=dtype_name, tol=tol, summary=label == DECODE_ATTN_SUMMARY)
    if iters:
        r["ms"], r["call_ms"] = timed(k6, iters)
        r["plain_ms"], _ = timed(plain, max(3, iters // 10))
        mask = (torch.arange(s, device="cuda")[None, :]
                <= pos[:, None])[:, None, None, :]
        try:
            r["library_ms"], _ = timed(
                lambda: F.scaled_dot_product_attention(
                    q, kc[1], vc[1], attn_mask=mask, enable_gqa=True),
                iters)
            r["library_call"] = ("scaled_dot_product_attention, boolean "
                                 "mask over the budget, enable_gqa")
        except Exception as e:  # the card's torch may not take it
            r["library_ms"] = None
            r["library_call"] = f"{type(e).__name__}: {e}"[:160]
        es = q.element_size()
        nbytes = (2 * hkv * d * es * (live - b)      # K, V rows read
                  + 2 * b * hkv * d * es             # rows p written
                  + 2 * b * h * d * es               # q read, out written
                  + 2 * b * hkv * d * es             # k, v read
                  + 2 * b * d // 2 * 4)              # cos, sin rows
        r["bound_ms"] = nbytes / peaks[0] * 1e3
        r["bound_by"] = "bytes"
        log(f"kernel decode_attention {label}: {100 * r['bound_ms'] / r['ms']:.1f}% "
            f"of its byte bound ({nbytes / 1e6:.1f} MB)")
    del q, k, v, kc, vc, kc_ref, vc_ref, out, again, ref, alone
    torch.cuda.empty_cache()
    return r


def _decode_attn_outside() -> None:
    """K6 at positions outside [0, S): those rows write nothing and
    attend to nothing (output 0); a row in range beside them equals the
    plain version's."""
    import torch

    from tony_tpu_torch.ops.decode_attention import (
        decode_attention_cuda, decode_attention_reference,
    )
    from tony_tpu_torch.ops.rope import rope_frequencies

    b, h, hkv, s, d = 3, 8, 2, 300, 128
    g = torch.Generator(device="cuda").manual_seed(17)

    def noise(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16)

    q = noise(b, 1, h, d).transpose(1, 2)
    k = noise(b, 1, hkv, d).transpose(1, 2)
    v = noise(b, 1, hkv, d).transpose(1, 2)
    kc, vc = noise(1, b, hkv, s, d), noise(1, b, hkv, s, d)
    cos, sin = rope_frequencies(d, s, 1e6, device=torch.device("cuda"))
    kc0, vc0 = kc.clone(), vc.clone()
    out = decode_attention_cuda(q, k, v, kc, vc, 0, cos, sin,
                                torch.tensor([-1, s, 200], device="cuda"))
    ref = decode_attention_reference(q[2:], k[2:], v[2:], kc0[:, 2:].clone(),
                                     vc0[:, 2:].clone(), 0, cos, sin,
                                     torch.tensor([200], device="cuda"))
    torch.cuda.synchronize()
    untouched = bool(torch.equal(kc[:, :2], kc0[:, :2])
                     and torch.equal(vc[:, :2], vc0[:, :2]))
    zeros = bool((out[:2] == 0).all())
    err, ok = max_err(out[2:], ref, TOL["bfloat16"])
    log(f"kernel decode_attention: positions -1 and S: rows untouched "
        f"{untouched}, outputs 0 {zeros}; the row at 200 beside them "
        f"max_abs_err {err:.3e}")
    check(untouched and zeros and ok,
          "decode attention outside [0, S) wrote, attended or disturbed "
          "its neighbour")


def _k5_step_ms(results: list[dict], key: str) -> tuple[float, float]:
    """The sums, over one decode step's products at M 4, of the cases'
    `key` (ms, bound_ms, ...): llama3_8b's 32 layers of wq, wk, wv, wo,
    w_gate, w_up, w_down, then the LM head; mixtral_proxy's 16 layers of
    wq, wk, wv, wo and its three expert banks, then the LM head."""
    by = {r["shape"].split(" M")[0].split(" E")[0]: r[key] for r in results
          if r["dtype"] == "bfloat16" and " M4 " in r["shape"] and key in r}
    llama = 32 * (2 * by["wq/wo"] + 2 * by["wk/wv"]
                  + 2 * by["w_gate/w_up"] + by["w_down"]) + by["output"]
    mixtral = 16 * (2 * by["mixtral wq/wo"] + 2 * by["mixtral wk/wv"]
                    + 2 * by["mixtral we_gate/we_up"]
                    + by["mixtral we_down"]) + by["mixtral output"]
    return llama, mixtral


def _report(name: str, r: dict) -> None:
    """Log one case of a kernel: its errors, times and bound."""
    line = (f"kernel {name} {r['dtype']} {r['shape']}: max_abs_err "
            f"{r['max_abs_err']:.3e} (tol {r['tol']})")
    if "norm_err" in r:
        line += (f" norm_err {r['norm_err']:.3e} row_err "
                 f"{r['row_err']:.3e} at {r['worst_row']} "
                 f"(tol {NORM_TOL})")
    if "bitwise" in r:
        line += f" bitwise over two calls {r['bitwise']}"
    if "ms" in r:
        lib, call = r["library_ms"], r.get("library_call")
        line += (f" ms {r['ms']:.4f} call_ms {r['call_ms']:.4f} "
                 f"plain_ms {r['plain_ms']:.4f} library_ms "
                 f"{'null' if lib is None else f'{lib:.4f}'}"
                 f"{f' ({call})' if call else ''}"
                 f" bound_ms {r['bound_ms']:.4f} ({r['bound_by']})")
    if "cold_ms" in r:
        line += (f" cold L2: ms {r['cold_ms']:.4f} library_ms "
                 f"{r['cold_library_ms']:.4f}")
    log(line + ("" if r["ok"] else "  <-- OUT OF TOLERANCE"))


def _hold_all(name: str, results: list[dict]) -> None:
    bad = [r for r in results if not r["ok"]]
    check(not bad, f"{name} disagrees with its plain version at "
                   + ", ".join(f"{r['dtype']} {r['shape']}" for r in bad))


def _vit_kernel_cases(add, peaks) -> None:
    """K1-K3 at ViT's attention shapes (VIT_FLASH_CASES: non-causal, no
    GQA group) and K4 at its rows (VIT_RMS_CASES), held as the other cases
    are; the timed ones with their ms, SDPA's and the bound, K1-K3 run
    twice and bit for bit. None of them is a kernel's summary entry."""
    import torch

    flush = torch.empty(2 * torch.cuda.get_device_properties(0).L2_cache_size
                        // 4, device="cuda")
    for b, h, s, d, dtype_name, timed_case in VIT_FLASH_CASES:
        dq, dkv, fwd = _flash_bwd_case(b, h, h, s, d, False, dtype_name,
                                       "bshd", peaks, timed_case=timed_case)
        if fwd is None:
            fwd = _flash_case(b, h, h, s, d, False,
                              getattr(torch, dtype_name), peaks, 0)
        for name, r in (("flash_fwd", fwd), ("flash_bwd_dq", dq),
                        ("flash_bwd_dkv", dkv)):
            r["summary"] = False
            r["shape"] = f"ViT {r['shape']}"
            add(name, r)
        torch.cuda.empty_cache()
    for rows, d in VIT_RMS_CASES:
        r = _rms_case(rows, d, torch.bfloat16, peaks, 100, flush)
        r["summary"] = False
        r["shape"] = f"ViT {r['shape']}"
        add("rmsnorm_fwd", r)
    del flush


def phase_kernels(peaks) -> dict[str, dict]:
    """Every kernel at every listed shape and dtype. Returns, per kernel,
    its timed bf16 summary entry (serving's largest shape for K1 and K4,
    the training shape for K2 and K3), with the worst bf16 error."""
    import torch

    from tony_tpu_torch.ops.attention import (
        FLASH_BWD_DKV, FLASH_BWD_DQ, FLASH_FWD,
    )
    from tony_tpu_torch.ops.decode_attention import DECODE_ATTENTION
    from tony_tpu_torch.ops.int8_matmul import INT8_MATMUL
    from tony_tpu_torch.ops.rmsnorm import RMSNORM_FWD

    cases = {FLASH_FWD.name: [], FLASH_BWD_DQ.name: [],
             FLASH_BWD_DKV.name: [], RMSNORM_FWD.name: [],
             INT8_MATMUL.name: [], DECODE_ATTENTION.name: []}
    # written and read back between RMSNorm launches timed with a cold L2:
    # twice the L2
    flush = torch.empty(2 * torch.cuda.get_device_properties(0).L2_cache_size
                        // 4, device="cuda")
    def add(name: str, r: dict) -> None:
        _report(name, r)
        cases[name].append(r)

    for dtype in (torch.bfloat16, torch.float32):
        for s in FLASH_SEQS:
            add(FLASH_FWD.name, _flash_case(1, 32, 8, s, 128, True, dtype,
                                            peaks, 20 if s >= 512 else 50))
        for rows, d in RMS_CASES:
            add(RMSNORM_FWD.name,
                _rms_case(rows, d, dtype, peaks, 100, flush))
    del flush
    for case in FLASH_CASES:
        add(FLASH_FWD.name, _flash_case(*case, torch.bfloat16, peaks, 0))
    for label, k, n, out_f32 in INT8_CASES:
        for m in INT8_ROWS:
            add(INT8_MATMUL.name, _int8_case(label, k, n, out_f32, m,
                                             "bfloat16", peaks, 50))
    for label, k, n, out_f32 in INT8_MOE_CASES:
        add(INT8_MATMUL.name, _int8_case(label, k, n, out_f32, 4,
                                         "bfloat16", peaks, 50))
    for case in INT8_BANK_CASES:
        add(INT8_MATMUL.name, _int8_bank_case(*case, "bfloat16", peaks, 50))
    for case in INT8_BANK_EXTRA:
        add(INT8_MATMUL.name, _int8_bank_case(*case, peaks, 0))
    for case in INT8_EXTRA:
        add(INT8_MATMUL.name, _int8_case(*case, peaks, 0))
    k5 = cases[INT8_MATMUL.name]
    for model, at in (("llama3_8b", 0), ("mixtral_proxy", 1)):
        log(f"kernel {INT8_MATMUL.name}: one {model} int8 decode step's "
            f"products at M 4: {_k5_step_ms(k5, 'ms')[at]:.4f} ms, bound "
            f"{_k5_step_ms(k5, 'bound_ms')[at]:.4f} ms, plain "
            f"{_k5_step_ms(k5, 'plain_ms')[at]:.4f} ms, library "
            f"{_k5_step_ms(k5, 'library_ms')[at]:.4f} ms")
    for case in DECODE_ATTN_CASES:
        add(DECODE_ATTENTION.name, _decode_attn_case(*case, peaks))
    _decode_attn_outside()
    # the backward cases run on K1's (out, lse): a wrong forward fails here,
    # under its own name
    for name in (FLASH_FWD.name, RMSNORM_FWD.name, INT8_MATMUL.name,
                 DECODE_ATTENTION.name):
        _hold_all(name, cases[name])
    for i, case in enumerate(BWD_CASES):
        layout = case[7] if len(case) > 7 else "bshd"
        dq, dkv, fwd = _flash_bwd_case(*case[:7], layout, peaks,
                                       timed_case=i == 0)
        add(FLASH_BWD_DQ.name, dq)
        add(FLASH_BWD_DKV.name, dkv)
        if fwd is not None:
            add(FLASH_FWD.name, fwd)
        torch.cuda.empty_cache()
    _vit_kernel_cases(add, peaks)
    summary = {}
    for name, results in cases.items():
        _hold_all(name, results)
        bf16 = [r for r in results if r["dtype"] == "bfloat16"]
        top = dict(next(r for r in bf16 if r["summary"]))
        top["max_abs_err"] = max(r["max_abs_err"] for r in bf16)
        summary[name] = top
    return summary


# ---------------------------------------------------------------------------
# phase 3: the serving path at full width
# ---------------------------------------------------------------------------

def _post(url: str, body: dict, stream: bool, timeout: float = 600.0
          ) -> dict:
    """One /v1/generate request; returns {tokens, finish_reason, wall_s,
    first_s} (first_s: client-side time to the first streamed token)."""
    body = dict(body, stream=stream)
    rq = urllib.request.Request(url + "/v1/generate",
                                data=json.dumps(body).encode(),
                                headers={"Content-Type": "application/json"})
    t0 = time.monotonic()
    first = None
    with urllib.request.urlopen(rq, timeout=timeout) as resp:
        if not stream:
            obj = json.loads(resp.read())
            return {"tokens": obj["tokens"],
                    "finish_reason": obj["finish_reason"],
                    "wall_s": time.monotonic() - t0, "first_s": None}
        tokens, finish = [], None
        for raw in resp:
            raw = raw.strip()
            if not raw:
                continue
            obj = json.loads(raw)
            if obj.get("done"):
                finish = obj["finish_reason"]
                break
            if first is None:
                first = time.monotonic() - t0
            tokens.append(obj["token"])
    return {"tokens": tokens, "finish_reason": finish,
            "wall_s": time.monotonic() - t0, "first_s": first}


def _k5_per_pass(cfg, rows: int) -> int:
    """K5's launches in one pass of `rows` tokens with int8 weights: per
    layer the 4 attention products, and the 3 MLP products (an MoE
    config: its 3 expert banks, one launch a bank, each expert over its
    queue of capacity rows), each where it has at most KERNEL_MAX_ROWS
    rows (an expert's queue); then the LM head on the last row (a
    prefill) or the slots' rows (a decode step)."""
    from tony_tpu_torch.ops.int8_matmul import KERNEL_MAX_ROWS
    per_layer = 4 * (rows <= KERNEL_MAX_ROWS)
    experts = getattr(cfg, "n_experts", 0)
    if experts:
        capacity = max(1, int(cfg.capacity_factor * rows * cfg.top_k
                              / experts))
        per_layer += 3 * (capacity <= KERNEL_MAX_ROWS)
    else:
        per_layer += 3 * (rows <= KERNEL_MAX_ROWS)
    return cfg.n_layers * per_layer + 1


def _k5_launches(cfg, prompt_lens, steps: int, slots: int) -> int:
    """K5's launches over a burst with int8 weights: each decode step over
    the slots' rows, and each admission's prefill of its prompt."""
    return steps * _k5_per_pass(cfg, slots) + sum(
        _k5_per_pass(cfg, n) for n in prompt_lens)


def _settled(engine) -> dict:
    """The engine's snapshot once its counters stop moving: a request's
    answer returns from the step's emit, before the step folds its sums,
    so the launches and the counted steps agree only after that fold."""
    before = dict(engine.snapshot())
    while True:
        time.sleep(0.1)
        now = dict(engine.snapshot())
        if (now["decode_steps"], now["admissions"]) == (
                before["decode_steps"], before["admissions"]):
            return now
        before = now


def _k6_launches(cfg, steps: int, flags=()) -> int:
    """K6's launches over a burst: one a layer in each decode step; none
    with an int8 cache (`--quant-cache`), whose rows take the dequantize
    path."""
    return 0 if "--quant-cache" in flags else cfg.n_layers * steps


def phase_serve(config_name: str, flags: tuple = (),
                tag: str = "serve", hold=None) -> dict[str, int]:
    """Returns each kernel's launch count over the burst. `flags` are
    added to the server's (the quant phase's `--quant int8
    --quant-cache`); `hold(server, prompts, finished)`, when given, runs
    more checks on the server after the burst (the moe phase's)."""
    import numpy as np
    import torch

    from tony_tpu_torch.ops import cuda_lib
    from tony_tpu_torch.ops.attention import (
        FLASH_BWD_DKV, FLASH_BWD_DQ, FLASH_FWD,
    )
    from tony_tpu_torch.ops.decode_attention import DECODE_ATTENTION
    from tony_tpu_torch.ops.int8_matmul import INT8_MATMUL
    from tony_tpu_torch.ops.rmsnorm import RMSNORM_FWD
    from tony_tpu_torch.serve.__main__ import build_arg_parser, build_server

    args = build_arg_parser().parse_args(
        ["--config", config_name, "--device", "cuda", "--slots", "4",
         "--token-budget", "2048", "--port", "0", "--host", "127.0.0.1",
         *flags])
    t0 = time.monotonic()
    server = build_server(args)
    engine, cfg = server.engine, server.engine.config
    log(f"{tag}: {' '.join(flags) or 'bf16'} server: "
        f"{config_name} (dim {cfg.dim}, {cfg.n_layers} layers, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, vocab {cfg.vocab_size}, "
        f"{str(cfg.dtype).split('.')[-1]}) built in "
        f"{time.monotonic() - t0:.1f} s; {engine.n_slots} slots, budget "
        f"{engine.token_budget}; weights "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    try:
        # one short request first: cuBLAS and allocator warm-up stay out
        # of the measured burst
        warm = _post(server.url, {"prompt": [1, 2, 3, 4, 5, 6, 7, 8],
                                  "max_new_tokens": 4}, stream=False)
        check(len(warm["tokens"]) == 4, f"warm-up request: {warm}")
        finished = []
        engine.on_request_finished = finished.append
        rng = np.random.RandomState(0)
        prompts = [[int(t) for t in rng.randint(0, cfg.vocab_size, size=n)]
                   for n in PROMPT_LENS]
        before = dict(engine.snapshot())
        torch.cuda.reset_peak_memory_stats()
        cuda_lib.reset_launches()
        results: dict[int, object] = {}

        def run(i: int) -> None:
            try:
                results[i] = _post(server.url,
                                   {"prompt": prompts[i],
                                    "max_new_tokens": MAX_NEW},
                                   stream=i < N_STREAMED)
            except Exception as e:  # noqa: BLE001 — reported below
                results[i] = e

        t_burst = time.monotonic()
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        burst_s = time.monotonic() - t_burst
        after = _settled(engine)
        launches = cuda_lib.launches()
        metrics = json.loads(urllib.request.urlopen(
            server.url + "/v1/metrics", timeout=30).read())
        peak_gib = torch.cuda.max_memory_allocated() / 2**30

        for i, n in enumerate(PROMPT_LENS):
            r = results.get(i)
            check(isinstance(r, dict), f"request {i} (prompt {n}): {r!r}")
            toks = r["tokens"]
            check(len(toks) == MAX_NEW and all(
                0 <= t < cfg.vocab_size for t in toks)
                and r["finish_reason"] == "length",
                f"request {i} (prompt {n}): {r}")
        check("tokens_emitted" in metrics, f"/v1/metrics: {metrics}")
        admissions = after["admissions"] - before["admissions"]
        steps = after["decode_steps"] - before["decode_steps"]
        check(admissions == len(PROMPT_LENS),
              f"{admissions} admissions for {len(PROMPT_LENS)} requests")
        want = {FLASH_FWD.name: cfg.n_layers * len(PROMPT_LENS),
                FLASH_BWD_DQ.name: 0, FLASH_BWD_DKV.name: 0,
                RMSNORM_FWD.name: (2 * cfg.n_layers + 1)
                * (admissions + steps),
                INT8_MATMUL.name: (_k5_launches(cfg, PROMPT_LENS, steps,
                                                engine.n_slots)
                                   if "int8" in flags else 0),
                DECODE_ATTENTION.name: _k6_launches(cfg, steps, flags)}
        log(f"{tag}: launches {launches}, expected {want} "
            f"({admissions} admissions, {steps} decode steps)")
        check(launches == want, f"launch counts {launches} != {want}")

        by_len = {len(h.prompt): h for h in finished}
        for i, n in enumerate(PROMPT_LENS):
            h = by_len[n]
            per_tok = h.decode_s / (len(h.tokens) - 1) * 1e3
            log(f"{tag}: request {i} prompt {n} "
                f"{'stream' if i < N_STREAMED else 'blocking'}: ttft "
                f"{h.ttft_s * 1e3:.1f} ms (queue {h.queue_wait_s * 1e3:.1f}"
                f" ms, prefill {h.prefill_s * 1e3:.1f} ms), decode "
                f"{per_tok:.2f} ms/token, wall {results[i]['wall_s']:.3f} s")
        total = len(PROMPT_LENS) * MAX_NEW
        ttfts = sorted(h.ttft_s * 1e3 for h in finished)
        log(f"{tag}: {total} tokens in {burst_s:.3f} s = "
            f"{total / burst_s:.1f} tokens/s; TTFT p50 "
            f"{ttfts[len(ttfts) // 2]:.1f} ms; decode p50 "
            f"{metrics['decode_ms_per_token_p50']:.2f} ms/token; peak "
            f"memory allocated {peak_gib:.2f} GiB")
        if hold is not None:
            hold(server, prompts, finished)

        # the 8B outputs are right in kind: a prefill's f32 logits are
        # finite and of the vocab's width
        from tony_tpu_torch.models.generate import prefill
        with torch.inference_mode():
            logits, _ = prefill(engine.params,
                                torch.tensor([prompts[1]], device="cuda"),
                                cfg, len(prompts[1]))
        check(logits.shape == (1, cfg.vocab_size)
              and logits.dtype == torch.float32
              and bool(torch.isfinite(logits).all()),
              f"{config_name} prefill logits {logits.shape} {logits.dtype}")
        return launches
    finally:
        server.stop(drain_timeout=0)
        del server, engine
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 4: engine against offline generate, tiny f32
# ---------------------------------------------------------------------------

def phase_engine() -> None:
    import numpy as np
    import torch

    from tony_tpu_torch.models.generate import generate
    from tony_tpu_torch.models.llama import (
        get_config, llama_forward, llama_init,
    )
    from tony_tpu_torch.serve.engine import ContinuousBatchingEngine

    cfg = get_config("tiny")
    with torch.inference_mode():
        params = llama_init(cfg, torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.RandomState(0)
    prompts = [[int(t) for t in rng.randint(0, cfg.vocab_size, size=n)]
               for n in (8, 5, 8, 11, 5, 3, 1)]

    # the forward on the card (kernels) against the forward on the CPU
    # (plain versions), same weights: f32 sums in another order
    cpu_params = {k: ({n: w.cpu() for n, w in v.items()}
                      if isinstance(v, dict) else v.cpu())
                  for k, v in params.items()}
    toks = torch.tensor([prompts[3]])
    got = llama_forward(params, toks.cuda(), cfg).cpu()
    want = llama_forward(cpu_params, toks, cfg)
    err = float((got - want).abs().max())
    log(f"engine: tiny forward card vs cpu max_abs_err {err:.3e} "
        f"(tol 1e-4)")
    check(err <= 1e-4, f"tiny forward on the card differs by {err}")

    engine = ContinuousBatchingEngine(params, cfg, n_slots=2,
                                      token_budget=32, queue_depth=16)

    def drain(handles, max_steps=200):
        for _ in range(max_steps):
            if all(h.done.is_set() for h in handles):
                return
            engine.step()
        raise SmokeFailure("engine did not finish the workload")

    handles = [engine.submit(prompts[0], 6), engine.submit(prompts[1], 6)]
    engine.step()
    engine.step()
    handles.append(engine.submit(prompts[2], 4))
    handles.append(engine.submit(prompts[3], 6))
    engine.step()
    handles.append(engine.submit(prompts[4], 3))
    handles.append(engine.submit(prompts[5], 5))
    handles.append(engine.submit(prompts[6], 5))
    drain(handles)
    for h, p in zip(handles, prompts):
        want = generate(params, cfg, torch.tensor([p], device="cuda"),
                        h.max_new_tokens)[0].tolist()
        check(h.tokens == want and h.finish_reason == "length",
              f"engine request {h.request_id} (prompt {len(p)}): "
              f"{h.tokens} != offline {want}")
    log(f"engine: {len(handles)} staggered requests equal offline "
        f"generate token for token")


# ---------------------------------------------------------------------------
# optional phase: where the serving path's time goes
# ---------------------------------------------------------------------------

def phase_profile(config_name: str) -> None:
    """A prefill of 1900 tokens into one slot and a decode step over 4
    slots at full width: host wall time (CUDA-synchronised, profiler off),
    device busy time and the top kernels by device time (torch.profiler),
    and the device's idle share, 1 - busy / wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tony_tpu_torch.models.generate import (
        decode_step, empty_cache, prefill,
    )
    from tony_tpu_torch.serve.__main__ import _load_model, build_arg_parser

    args = build_arg_parser().parse_args(["--config", config_name])
    device = torch.device("cuda")
    params, cfg = _load_model(args, device)
    slots, budget = 4, 2048
    cache = empty_cache(cfg, slots, budget, device)
    g = torch.Generator(device="cuda").manual_seed(0)
    prompt = torch.randint(0, cfg.vocab_size, (1, 1900), generator=g,
                           device="cuda")
    rows = {n: a[:, 0:1] for n, a in cache.items()}
    tokens = torch.randint(0, cfg.vocab_size, (slots,), generator=g,
                           device="cuda")
    pos = torch.tensor([1900, 700, 300, 20], device="cuda")
    work = {
        "prefill 1900 tokens": lambda: prefill(params, prompt, cfg, budget,
                                               cache=rows),
        "decode step, 4 slots": lambda: decode_step(params, cfg, cache,
                                                    tokens, pos),
    }
    with torch.inference_mode():
        for label, fn in work.items():
            fn()
            torch.cuda.synchronize()
            walls = []
            for _ in range(5):
                t0 = time.monotonic()
                fn()
                torch.cuda.synchronize()
                walls.append((time.monotonic() - t0) * 1e3)
            wall = sorted(walls)[len(walls) // 2]
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            kernels = device_events(prof)
            busy = sum(_device_us(e) for e in kernels) / 1e3
            n_launch = sum(e.count for e in kernels)
            log(f"profile: {label}: wall {wall:.2f} ms (median of 5), "
                f"device busy {busy:.2f} ms, idle share "
                f"{max(0.0, 1 - busy / wall):.3f}, {n_launch} device ops")
            log_top(kernels, 10)
    del params, cache
    torch.cuda.empty_cache()


def _nrmse(got, want) -> float:
    """||got - want||_rms / ||want||_rms, as tests/test_quant.py holds
    int8 logits to bf16's."""
    g, w = got.float(), want.float()
    return float((g - w).square().mean().sqrt() / w.square().mean().sqrt())


def moe_breakdown(prof, n_experts: int) -> dict[str, float]:
    """Device ms of an MoE profile's parts, by the host op that launched
    each kernel (the profile recorded its shapes): the expert banks'
    bf16 products (`bmm` over n_experts batches; the decode step's
    attention einsums are `bmm`s over B x Hkv; an int8 bank's products
    are K5's, counted with K5), the dispatch and combine gathers and
    slot writes (the indexing ops, forward and backward), and the
    router's products (`mm` with an operand of n_experts columns or
    rows)."""
    parts = {"expert products": 0.0, "dispatch gathers/scatters": 0.0,
             "router products": 0.0}
    gathers = re.compile(r"aten::(index|index_put_|_index_put_impl_|gather|"
                         r"scatter|scatter_|index_select)$")
    for e in prof.key_averages(group_by_input_shape=True):
        us = e.self_device_time_total
        if not us or str(e.device_type).endswith("CUDA"):
            continue
        shapes = [sh for sh in (e.input_shapes or []) if sh]
        if e.key == "aten::bmm" and shapes and shapes[0][0] == n_experts:
            parts["expert products"] += us / 1e3
        elif gathers.match(e.key):
            parts["dispatch gathers/scatters"] += us / 1e3
        elif e.key == "aten::mm" and any(
                n_experts in shape for shape in shapes if len(shape) == 2):
            parts["router products"] += us / 1e3
    return parts


def _profile_step(label: str, fn, tag: str, n_experts: int = 0) -> dict:
    """Host wall (median of 5, CUDA-synchronised, profiler off), device
    busy time and idle share of fn(), K5's share of the busy time, and the
    top device ops; with `n_experts`, the MoE breakdown too."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        walls.append((time.monotonic() - t0) * 1e3)
    wall = sorted(walls)[len(walls) // 2]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=bool(n_experts)) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = device_events(prof)
    busy = sum(_device_us(e) for e in kernels) / 1e3
    k5 = sum(_device_us(e) for e in kernels
             if re.search(r"\bw8a16<", e.key)) / 1e3
    n_ops = sum(e.count for e in kernels)
    log(f"{tag}: {label}: wall {wall:.2f} ms (median of 5), device busy "
        f"{busy:.2f} ms, idle share {max(0.0, 1 - busy / wall):.3f}, "
        f"{n_ops} device ops, K5 {k5:.3f} ms")
    if n_experts:
        parts = moe_breakdown(prof, n_experts)
        log(f"{tag}: {label}: " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in parts.items()))
    log_top(kernels, 6)
    return {"wall_ms": wall, "busy_ms": busy, "k5_ms": k5, "ops": n_ops}


def phase_quant(config_name: str) -> dict[str, int]:
    """llama3_8b with bf16 random weights from the fixed seed, quantized
    on the card: int8-weight and int8-cache logits against bf16's
    (prefill and a decode step), the decode step profiled in the three
    modes, then the `--quant int8 --quant-cache` server's burst with exact
    K1, K4 and K5 launches. Returns the burst's launches."""
    import torch

    from tony_tpu_torch.models.generate import (
        decode_step, empty_cache, prefill,
    )
    from tony_tpu_torch.models.quant import quantize_params, quantized_bytes
    from tony_tpu_torch.serve.__main__ import _load_model, build_arg_parser

    device = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    params, cfg = _load_model(build_arg_parser().parse_args(
        ["--config", config_name]), device)
    t0 = time.monotonic()
    with torch.inference_mode():
        qparams = quantize_params(params)
    torch.cuda.synchronize()
    now, full = quantized_bytes(qparams)
    log(f"quant: {config_name} quantized on the card in "
        f"{time.monotonic() - t0:.1f} s: {now / 1e9:.3f} GB of int8 weights "
        f"and scales where bf16 holds {full / 1e9:.3f} GB")
    g = torch.Generator(device="cuda").manual_seed(11)
    b, p = QUANT_PROMPTS
    tokens = torch.randint(0, cfg.vocab_size, (b, p), generator=g,
                           device="cuda")
    errs = {}
    with torch.inference_mode():
        ref, ref_cache = prefill(params, tokens, cfg, p + 8)
        tok = torch.argmax(ref, dim=-1)
        d_ref, _ = decode_step(params, cfg, ref_cache, tok, p)
        for mode, (w, qc) in {"int8 weights": (qparams, False),
                              "int8 cache": (params, True),
                              "both": (qparams, True)}.items():
            logits, cache = prefill(w, tokens, cfg, p + 8, quant_cache=qc)
            if mode == "int8 cache":
                check(torch.equal(logits, ref),
                      "int8-cache prefill logits differ from bf16's (the "
                      "cache is written after them)")
            d, _ = decode_step(w, cfg, cache, tok, p)
            errs[mode] = (_nrmse(logits, ref), _nrmse(d, d_ref))
            check(bool(torch.isfinite(d).all()), f"{mode}: decode logits")
    for mode, (e_pre, e_dec) in errs.items():
        log(f"quant: {mode}: normalized RMSE against bf16: prefill "
            f"{e_pre:.4f}, decode {e_dec:.4f} (limit {QUANT_NRMSE})")
        check(e_pre < QUANT_NRMSE and e_dec < QUANT_NRMSE,
              f"{mode} logits: normalized RMSE {e_pre}, {e_dec}")

    steps = {}
    with torch.inference_mode():
        caches = {qc: empty_cache(cfg, DECODE_SLOTS, DECODE_BUDGET, device,
                                  quant_cache=qc) for qc in (False, True)}
        tok = torch.randint(0, cfg.vocab_size, (DECODE_SLOTS,), generator=g,
                            device="cuda")
        pos = torch.tensor(DECODE_POS, device="cuda")
        for label, w, qc in (("bf16", params, False),
                             ("int8 weights", qparams, False),
                             ("int8 weights + int8 cache", qparams, True)):
            steps[label] = _profile_step(
                f"decode step, {DECODE_SLOTS} slots, {label}",
                lambda w=w, qc=qc: decode_step(w, cfg, caches[qc], tok, pos),
                "quant")
    log(f"quant: decode step device busy bf16 "
        f"{steps['bf16']['busy_ms']:.2f} ms, int8 weights "
        f"{steps['int8 weights']['busy_ms']:.2f} ms, + int8 cache "
        f"{steps['int8 weights + int8 cache']['busy_ms']:.2f} ms; peak "
        f"memory allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB (bf16 and int8 weights resident together)")
    del params, qparams, caches, ref_cache
    torch.cuda.empty_cache()
    return phase_serve(config_name, ("--quant", "int8", "--quant-cache"),
                       "quant")


def _kv_prompts(cfg) -> list[list[int]]:
    import numpy as np
    rng = np.random.RandomState(3)
    prefix = [int(t) for t in rng.randint(0, cfg.vocab_size, KV_PREFIX)]
    return [prefix + [int(t) for t in rng.randint(0, cfg.vocab_size, n)]
            for n in KV_SUFFIXES]


def _kv_run(engine, prompts, tag: str) -> dict:
    """The prompts one after another through the engine's loop (each
    waits for the last, so a TTFT holds no queueing): tokens, TTFT and
    prefill seconds per request, and the launches and admissions of the
    run."""
    import torch

    from tony_tpu_torch.ops import cuda_lib

    before = dict(engine.snapshot())
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    handles = []
    for p in prompts:
        h = engine.submit(p, MAX_NEW)
        h.result(timeout=600)
        check(h.finish_reason == "length" and len(h.tokens) == MAX_NEW,
              f"{tag}: request {h.request_id}: {h.finish_reason}")
        handles.append(h)
    torch.cuda.synchronize()
    after = _settled(engine)
    launches = cuda_lib.launches()
    return {"tokens": [h.tokens for h in handles],
            "wall_s": [h.finished_at - h.submitted_at for h in handles],
            "ttft_s": [h.ttft_s for h in handles],
            "prefill_s": [h.prefill_s for h in handles],
            "matched": [h.kv_matched_tokens for h in handles],
            "launches": launches,
            "admissions": after["admissions"] - before["admissions"],
            "steps": after["decode_steps"] - before["decode_steps"]}


def _kv_logits(params, cfg, prompt) -> None:
    """The first token's logits through the page pool: the prefix
    prefilled into slot 0, sealed into pages, gathered into slot 1, the
    suffix prefilled there; equal bit for bit to the same suffix prefill
    on slot 0's own prefix rows (the paging moves bytes and nothing
    else). Printed beside the full prefill of the prompt (sharing off,
    K1) and the suffix prefill of the whole prompt from position 0 (the
    JAX package's sharing-on path for a prompt that matches nothing),
    against bf16's 3e-2 and by norm 1e-2; then the suffix prefill and the
    full prefill profiled."""
    import torch

    from tony_tpu_torch.models.generate import empty_cache, prefill
    from tony_tpu_torch.serve import kvcache as kvc

    device = torch.device("cuda")
    pool = kvc.KVPagePool(cfg, DECODE_BUDGET, KV_PAGE, n_slots=1,
                          device=device)
    cache = empty_cache(cfg, 3, DECODE_BUDGET, device)
    n_pages = KV_PREFIX // KV_PAGE
    table = torch.zeros(pool.blocks_per_slot, dtype=torch.long)
    table[:n_pages] = torch.arange(1, n_pages + 1)
    table = table.to(device)
    tokens = torch.tensor(prompt, device=device)
    rows = {name: a[:, 0:1] for name, a in cache.items()}
    with torch.inference_mode():
        prefill(params, tokens[None, :KV_PREFIX], cfg, DECODE_BUDGET,
                cache=rows)
        kvc.seal_pages(pool.pool, cache, table, 0)
        kvc.gather_pages(cache, pool.pool, table, 1)
        on, _ = kvc.prefill_suffix(params, cfg, cache, tokens[KV_PREFIX:],
                                   KV_PREFIX, 1)
        direct, _ = kvc.prefill_suffix(params, cfg, cache,
                                       tokens[KV_PREFIX:], KV_PREFIX, 0)
        miss, _ = kvc.prefill_suffix(params, cfg, cache, tokens, 0, 2)
        off, _ = prefill(params, tokens[None], cfg, DECODE_BUDGET,
                         cache=rows)
    same = bool(torch.equal(on, direct))
    log(f"kvcache: first-token logits through the pages equal those on "
        f"the slot's own prefix rows bit for bit: {same}")
    check(same, "paged suffix prefill differs from the same suffix prefill "
                "on the prefix rows it was gathered from")
    tol = TOL["bfloat16"]
    for label, got in (("sharing on (paged)", on),
                       ("suffix prefill from 0", miss)):
        e = hold(got, off, tol, by_norm=True, name="logits")
        log(f"kvcache: first-token logits, {label} against sharing off "
            f"(full prefill, K1): max_abs_err {e['max_abs_err']:.3e} (tol "
            f"{tol}), norm_err {e['norm_err']:.3e} (tol {NORM_TOL}); "
            f"argmax {int(got.argmax())} / {int(off.argmax())}")
    with torch.inference_mode():
        _profile_step(
            f"suffix prefill of {len(prompt) - KV_PREFIX} tokens after "
            f"{KV_PREFIX} gathered",
            lambda: kvc.prefill_suffix(params, cfg, cache,
                                       tokens[KV_PREFIX:], KV_PREFIX, 1),
            "kvcache")
        _profile_step(f"full prefill of {len(prompt)} tokens",
                      lambda: prefill(params, tokens[None], cfg,
                                      DECODE_BUDGET, cache=rows), "kvcache")
    del pool, cache, rows
    torch.cuda.empty_cache()


def _kv_relay(params, cfg, prompts, local) -> None:
    """A prefill-role and a decode-role server in this process on the
    same parameters, relaying over HTTP: greedy streams (blocking and
    streamed) bit-identical to local decode (`local`: the sharing-off
    run), and the wall of a migrated request beside the local one."""
    from tony_tpu_torch.serve.engine import ContinuousBatchingEngine
    from tony_tpu_torch.serve.frontend import ServeFrontend

    def engine(role):
        return ContinuousBatchingEngine(
            params, cfg, n_slots=DECODE_SLOTS, token_budget=DECODE_BUDGET,
            role=role)
    dec, pre = engine("decode"), engine("prefill")
    dec_fe = ServeFrontend(dec, port=0, host="127.0.0.1")
    pre_fe = ServeFrontend(pre, port=0, host="127.0.0.1", migrate_targets=[
        f"http://127.0.0.1:{dec_fe.port}"])
    try:
        for e in (dec, pre):
            e.start()
        for fe in (dec_fe, pre_fe):
            fe.start()
        url = f"http://127.0.0.1:{pre_fe.port}"
        for i, p in enumerate(prompts):
            want = local["tokens"][i]
            r = _post(url, {"prompt": p, "max_new_tokens": MAX_NEW},
                      stream=bool(i % 2))
            log(f"kvcache: migrated request {i} (prompt {len(p)}, "
                f"{'stream' if i % 2 else 'blocking'}): wall "
                f"{r['wall_s'] * 1e3:.1f} ms (client), local "
                f"{local['wall_s'][i] * 1e3:.1f} ms (engine); tokens "
                f"equal local decode {r['tokens'] == want}")
            check(r["tokens"] == want,
                  f"migrated stream {r['tokens']} != local {want}")
        snap = dec.snapshot()
        check(snap["migrated_in_total"] == len(prompts)
              and pre.snapshot()["migrated_out_total"] == len(prompts),
              f"migrations: {snap['migrated_in_total']} in")
    finally:
        for fe in (pre_fe, dec_fe):
            fe.stop()
        for e in (pre, dec):
            e.stop()


def _kv_tiny() -> None:
    """tiny f32 on the card: the engine's greedy streams with sharing on
    equal those with it off, under staggered arrivals."""
    import numpy as np
    import torch

    from tony_tpu_torch.models.llama import get_config, llama_init
    from tony_tpu_torch.serve.engine import ContinuousBatchingEngine

    cfg = get_config("tiny")
    with torch.inference_mode():
        params = llama_init(cfg, torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.RandomState(6)
    shared = [int(t) for t in rng.randint(0, cfg.vocab_size, 8)]
    prompts = [shared + [int(t) for t in rng.randint(0, cfg.vocab_size, n)]
               for n in (5, 3, 9, 1, 6)]
    outs = {}
    for sharing in (False, True):
        engine = ContinuousBatchingEngine(
            params, cfg, n_slots=2, token_budget=32, queue_depth=16,
            prefix_sharing=sharing, kv_page_size=4)
        handles = [engine.submit(p, 4) for p in prompts[:2]]
        for _ in range(3):
            engine.step()
        handles += [engine.submit(p, 4) for p in prompts[2:]]
        for _ in range(200):
            if all(h.done.is_set() for h in handles):
                break
            engine.step()
        outs[sharing] = [h.tokens for h in handles]
        if sharing:
            hits = engine.kv_pool.req_hits
    log(f"kvcache: tiny f32 staggered streams, sharing on equal to off: "
        f"{outs[True] == outs[False]} ({hits} pool hits)")
    check(outs[True] == outs[False] and hits == len(prompts) - 1,
          f"tiny sharing on {outs[True]} != off {outs[False]}")


def phase_kvcache(config_name: str) -> dict[str, int]:
    """llama3_8b bf16 with prefix sharing: 8 prompts sharing a 1024-token
    prefix with distinct suffixes, through an engine with sharing on and
    one with it off (same parameters): pool hits exact, K1 launched only
    for the unmatched admission, TTFT on against off, first-token logits
    on against off, the prefill -> decode relay over HTTP, and tiny f32
    on equal to off. Returns the sharing-on run's launches."""
    import torch

    from tony_tpu_torch.ops.attention import (
        FLASH_BWD_DKV, FLASH_BWD_DQ, FLASH_FWD,
    )
    from tony_tpu_torch.ops.decode_attention import DECODE_ATTENTION
    from tony_tpu_torch.ops.int8_matmul import INT8_MATMUL
    from tony_tpu_torch.ops.rmsnorm import RMSNORM_FWD
    from tony_tpu_torch.serve.__main__ import _load_model, build_arg_parser
    from tony_tpu_torch.serve.engine import ContinuousBatchingEngine

    device = torch.device("cuda")
    params, cfg = _load_model(build_arg_parser().parse_args(
        ["--config", config_name]), device)
    prompts = _kv_prompts(cfg)
    runs = {}
    for sharing in (True, False):
        engine = ContinuousBatchingEngine(
            params, cfg, n_slots=DECODE_SLOTS, token_budget=DECODE_BUDGET,
            prefix_sharing=sharing, kv_page_size=KV_PAGE)
        engine.start()
        try:
            warm = engine.submit([1, 2, 3, 4, 5, 6, 7, 8], 4)
            warm.result(timeout=600)
            runs[sharing] = _kv_run(engine, prompts,
                                    f"kvcache (sharing {sharing})")
            if sharing:
                pool = engine.kv_pool
                pool.check_invariants()
                stats = dict(pool.stats_fields())
        finally:
            engine.stop()
        del engine
        torch.cuda.empty_cache()
    on, off = runs[True], runs[False]
    hits = len(prompts) - 1
    log(f"kvcache: pool after the run: {stats}")
    check(on["matched"] == [0] + [KV_PREFIX] * hits,
          f"matched prefix tokens {on['matched']}")
    check(stats["kv_req_hit_total"] == hits
          and stats["kv_hit_total"] == hits * KV_PREFIX,
          f"pool hits {stats['kv_req_hit_total']} requests, "
          f"{stats['kv_hit_total']} tokens")
    want = {FLASH_FWD.name: cfg.n_layers, FLASH_BWD_DQ.name: 0,
            FLASH_BWD_DKV.name: 0, INT8_MATMUL.name: 0,
            RMSNORM_FWD.name: (2 * cfg.n_layers + 1)
            * (on["admissions"] + on["steps"]),
            DECODE_ATTENTION.name: _k6_launches(cfg, on["steps"])}
    log(f"kvcache: sharing on: launches {on['launches']}, expected {want} "
        f"({on['admissions']} admissions, {on['steps']} decode steps)")
    check(on["launches"] == want,
          f"sharing-on launches {on['launches']} != {want}")
    for i, p in enumerate(prompts):
        same = on["tokens"][i] == off["tokens"][i]
        log(f"kvcache: request {i} prompt {len(p)} (matched "
            f"{on['matched'][i]}): ttft on {on['ttft_s'][i] * 1e3:.1f} ms "
            f"(prefill {on['prefill_s'][i] * 1e3:.1f}), off "
            f"{off['ttft_s'][i] * 1e3:.1f} ms (prefill "
            f"{off['prefill_s'][i] * 1e3:.1f}); stream equal {same}"
            + ("" if same else f": on {on['tokens'][i]} off "
                               f"{off['tokens'][i]}"))
    med = {k: sorted(r["ttft_s"][1:])[hits // 2] * 1e3
           for k, r in runs.items()}
    log(f"kvcache: TTFT median over the {hits} hits: sharing on "
        f"{med[True]:.1f} ms, off {med[False]:.1f} ms")
    _kv_logits(params, cfg, prompts[1])
    _kv_relay(params, cfg, prompts[:2], off)
    del params
    torch.cuda.empty_cache()
    _kv_tiny()
    return on["launches"]


# ---------------------------------------------------------------------------
# phase 6: the training path at full width
# ---------------------------------------------------------------------------

def _step_launches(n_layers: int) -> dict[str, int]:
    """The kernel launches one save_flash training step must make: the
    flash forward once per layer (the replay takes its saved out and lse),
    each backward kernel once per layer, RMSNorm twice per layer plus the
    final norm in the forward and twice per layer again in the replay; K5
    never (the weights are bf16), K6 never (no decode step)."""
    return {"flash_fwd": n_layers, "flash_bwd_dq": n_layers,
            "flash_bwd_dkv": n_layers, "rmsnorm_fwd": 4 * n_layers + 1,
            "int8_matmul": 0, "decode_attention": 0}


def _forward_launches(n_layers: int) -> dict[str, int]:
    """The kernel launches of one forward without a graph (the eval step):
    the flash forward once per layer, RMSNorm twice per layer plus the
    final norm."""
    return {"flash_fwd": n_layers, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "rmsnorm_fwd": 2 * n_layers + 1, "int8_matmul": 0,
            "decode_attention": 0}


def phase_train() -> dict[str, int]:
    """The train phase's run (`_train_run` on TRAIN_CONFIG). Returns each
    kernel's launches over the run."""
    run = _train_run(TRAIN_CONFIG, TRAIN_BATCH, TRAIN_PEAK_GIB, "train")
    TRAIN_INTERVAL["s"] = run["step_s"]
    return run["launches"]


def _train_run(config_name: str, batch: int, peak_limit_gib: float,
               tag: str) -> dict:
    """One `Trainer.run()`, built as `python -m tony_tpu_torch.train
    --config config_name` builds it, of TRAIN_STEPS steps at batch x
    TRAIN_SEQ and a profiled last one. Its step is wrapped to count each
    step's kernel launches (counts set to 0 just before the step, read
    just after); the step time, tokens/s and MFU are the Trainer's own
    `metrics_history`. An MoE config's profile also gives its breakdown.
    Returns {"launches" over the run, "losses", "step_s"}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tony_tpu_torch.device import peak_flops
    from tony_tpu_torch.ops import cuda_lib
    from tony_tpu_torch.train.__main__ import build_arg_parser, build_trainer

    steps = TRAIN_STEPS + 1                  # the last one is profiled
    args = build_arg_parser().parse_args(
        ["--config", config_name, "--device", "cuda", "--steps",
         str(steps), "--batch-size", str(batch), "--seq-len",
         str(TRAIN_SEQ), "--log-every", "1"])
    t0 = time.monotonic()
    trainer, cfg = build_trainer(args)
    trainer.setup()
    experts = getattr(cfg, "n_experts", 0)
    moe_desc = (f", {experts} experts top-{cfg.top_k}, capacity_factor "
                f"{cfg.capacity_factor}, {cfg.active_params() / 1e9:.3f} B "
                f"active" if experts else "")
    log(f"{tag}: {config_name} (dim {cfg.dim}, {cfg.n_layers} layers, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, ffn {cfg.ffn_dim}, vocab "
        f"{cfg.vocab_size}, {str(cfg.dtype).split('.')[-1]}, remat "
        f"{cfg.remat_policy if cfg.remat else 'off'}, xent_chunk "
        f"{cfg.xent_chunk}{moe_desc}), batch {batch} x {TRAIN_SEQ}; set up "
        f"in {time.monotonic() - t0:.1f} s, "
        f"{cfg.num_params() / 1e9:.3f} B parameters, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    want = _step_launches(cfg.n_layers)
    step_fn = trainer.train_step
    per_step: list[dict[str, int]] = []
    profiled: dict = {}

    def counted_step(params, opt_state, batch):
        """The Trainer's step with its launches counted; the last step runs
        under the profiler, from a drained device to a drained device."""
        cuda_lib.reset_launches()
        if len(per_step) + 1 < steps:
            out = step_fn(params, opt_state, batch)
        else:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA],
                         record_shapes=bool(experts)) as prof:
                t_step = time.monotonic()
                out = step_fn(params, opt_state, batch)
                torch.cuda.synchronize()
                profiled["wall_ms"] = (time.monotonic() - t_step) * 1e3
            profiled["prof"] = prof
        per_step.append({name: cuda_lib.launches()[name] for name in want})
        return out

    trainer.train_step = counted_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer.run()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    history = trainer.metrics_history
    check(len(history) == steps and len(per_step) == steps,
          f"{len(history)} log entries, {len(per_step)} steps, want {steps}")
    total = {name: 0 for name in want}
    for entry, got in zip(history, per_step):
        log(f"{tag}: step {entry['step']} loss {entry['loss']:.4f} "
            f"interval tokens/s {entry.get('tokens_per_s', 0.0):.1f} "
            f"launches {got}")
        check(got == want, f"step {entry['step']} launches {got} != {want}")
        for name in want:
            total[name] += got[name]
    losses = [e["loss"] for e in history]
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    # With log_every 1 the Trainer reads step k-1's loss at step k's
    # boundary, so in steady state the host time between two boundaries is
    # one step of device time. Step 1's interval is host issue alone, step
    # 2's holds the warm-up, and the last is profiled: steps 3-5 count.
    window = history[TRAIN_STEPS - 3:TRAIN_STEPS]
    check(all("mfu_pct" in e for e in window),
          f"the Trainer reported no MFU: {window}")
    tok_s = sorted(e["tokens_per_s"] for e in window)[1]
    mfu = sorted(e["mfu_pct"] for e in window)[1]
    peak = peak_flops(torch.device("cuda"))
    # the Trainer counts a batch's B x (S + 1) tokens, as the JAX one does
    step_s = batch * (TRAIN_SEQ + 1) / tok_s
    log(f"{tag}: the Trainer's median interval over steps "
        f"{TRAIN_STEPS - 2}-{TRAIN_STEPS}: {step_s:.4f} s per step = "
        f"{tok_s:.1f} "
        f"tokens/s, MFU {mfu:.2f}% of {peak / 1e12:.0f} TFLOP/s "
        f"(flops_per_token {cfg.flops_per_token(TRAIN_SEQ):.4e}); peak "
        f"memory allocated {peak_gib:.2f} GiB (limit {peak_limit_gib})")
    check(peak_gib <= peak_limit_gib,
          f"peak memory {peak_gib:.2f} GiB > {peak_limit_gib} GiB")

    wall = profiled["wall_ms"]
    kernels = device_events(profiled["prof"])
    busy = sum(_device_us(e) for e in kernels) / 1e3
    copies = [e for e in kernels if "copy" in e.key.lower()
              or "memcpy" in e.key.lower()]
    log(f"profile: {tag} step {steps}: wall {wall:.2f} ms, device busy "
        f"{busy:.2f} ms, idle share {max(0.0, 1 - busy / wall):.3f}, "
        f"{sum(e.count for e in kernels)} device ops, of which "
        f"{sum(e.count for e in copies)} copies "
        f"({sum(_device_us(e) for e in copies) / 1e3:.2f} ms)")
    if experts:
        parts = moe_breakdown(profiled["prof"], experts)
        log(f"profile: {tag} step {steps}: " + ", ".join(
            f"{k} {v:.2f} ms" for k, v in parts.items()))
    log_top(kernels, 12)
    del trainer, profiled, step_fn
    torch.cuda.empty_cache()
    return {"launches": total, "losses": losses, "step_s": step_s}


def phase_train_parity() -> None:
    """`tiny` in f32 (save_flash remat on, so the selective checkpoint
    runs too), 3 SGD steps on the same batches from the same weights: on
    the card through the kernels, on the CPU through the plain versions.
    f32 sums in another order over three steps: 1e-4."""
    import torch

    from tony_tpu_torch.models.llama import get_config, llama_init, llama_loss
    from tony_tpu_torch.train.data import synthetic_tokens
    from tony_tpu_torch.train.optim import sgd, tree_leaves
    from tony_tpu_torch.train.step import make_train_step

    cfg = get_config("tiny", remat=True)
    with torch.no_grad():
        init = llama_init(cfg, torch.Generator().manual_seed(0))
    batches = synthetic_tokens(4, 64, cfg.vocab_size, seed=3)
    batches = [torch.from_numpy(next(batches)["tokens"]) for _ in range(3)]
    results = {}
    for device in ("cuda", "cpu"):
        params = {k: ({n: w.to(device, copy=True).requires_grad_()
                       for n, w in v.items()} if isinstance(v, dict)
                      else v.to(device, copy=True).requires_grad_())
                  for k, v in init.items()}
        opt = sgd(0.1)
        state = opt.init(params)
        fn = make_train_step(lambda p, b: llama_loss(p, b, cfg), opt)
        losses = []
        for tokens in batches:
            params, state, loss = fn(params, state,
                                     {"tokens": tokens.to(device)})
            losses.append(float(loss))
        results[device] = (losses, [t.detach().cpu()
                                    for t in tree_leaves(params)])
    loss_err = max(abs(a - b) for a, b in zip(results["cuda"][0],
                                              results["cpu"][0]))
    param_err = max(float((a - b).abs().max()) for a, b in
                    zip(results["cuda"][1], results["cpu"][1]))
    log(f"train: tiny 3 SGD steps, card vs cpu: losses "
        f"{results['cuda'][0]} vs {results['cpu'][0]}, max loss err "
        f"{loss_err:.3e}, max param err {param_err:.3e} (tol 1e-4)")
    check(loss_err <= 1e-4 and param_err <= 1e-4,
          f"tiny training on the card differs from the CPU by "
          f"{loss_err}, {param_err}")


# ---------------------------------------------------------------------------
# phase 7: checkpoint, resume, eval, master weights and preemption
# ---------------------------------------------------------------------------

class _Timings:
    """Wall seconds of the checkpoint module's snapshot and file write and
    of the Trainer's restore, by wrapping them for the phase (the writes
    of an async save run on its thread)."""

    def __init__(self):
        from tony_tpu_torch.train import checkpoint, trainer
        self.seconds: dict[str, list[float]] = {
            "snapshot": [], "write": [], "restore": []}
        self._patched = []
        for module, attr, key in ((checkpoint, "_snapshot", "snapshot"),
                                  (checkpoint, "_write_rank_files", "write"),
                                  (trainer, "restore_checkpoint", "restore")):
            self._patched.append((module, attr, getattr(module, attr)))
            setattr(module, attr, self._timed(getattr(module, attr), key))

    def _timed(self, fn, key):
        def wrapped(*args, **kwargs):
            t0 = time.monotonic()
            out = fn(*args, **kwargs)
            self.seconds[key].append(time.monotonic() - t0)
            return out
        return wrapped

    def clear(self) -> None:
        for times in self.seconds.values():
            times.clear()

    def line(self) -> str:
        t = self.seconds
        ms = ", ".join(f"{x * 1e3:.1f}" for x in t["snapshot"])
        return (f"snapshot {ms} ms; commit "
                f"{', '.join(f'{x:.2f}' for x in t['write'])} s; restore "
                f"{', '.join(f'{x:.2f}' for x in t['restore'])} s")

    def close(self) -> None:
        for module, attr, fn in self._patched:
            setattr(module, attr, fn)


# a gsutil for the ckpt phase's gs:// run, which needs no network and no
# bucket: gs://<bucket>/<key> maps onto $FAKE_GCS_ROOT/<bucket>/<key> (cp,
# ls with wildcards, rm), as the tests' stand-in does
GSUTIL_STAND_IN = """#!/bin/bash
set -e
cmd=$1; shift
map() { echo "$FAKE_GCS_ROOT/${1#gs://}"; }
unmap() { echo "gs://${1#"$FAKE_GCS_ROOT/"}"; }
case "$cmd" in
  cp)
    src=$1; dst=$2
    [[ $src == gs://* ]] && src=$(map "$src")
    if [[ $dst == gs://* ]]; then dst=$(map "$dst"); mkdir -p "$(dirname "$dst")"; fi
    cp "$src" "$dst"
    ;;
  ls)
    if [[ $1 == *'*'* ]]; then
      shopt -s globstar nullglob
      mapped=$(map "$1")
      found=0
      for p in $mapped; do
        [[ -f $p ]] && { unmap "$p"; found=1; }
      done
      [[ $found == 1 ]] || { echo "CommandException: no URLs matched" >&2; exit 1; }
    else
      p=$(map "$1"); [[ -e $p ]] || { echo "CommandException: no URLs matched" >&2; exit 1; }
    fi
    ;;
  rm)
    p=$(map "$1")
    [[ -f $p ]] || { echo "CommandException: No URLs matched" >&2; exit 1; }
    rm -f "$p"
    ;;
  *) echo "unsupported: $cmd" >&2; exit 2 ;;
esac
"""


@contextlib.contextmanager
def _gsutil_stand_in(root: str):
    """GSUTIL_STAND_IN first on PATH, its objects under `root`/gcs."""
    bindir = os.path.join(root, "gsutil-bin")
    os.makedirs(bindir, exist_ok=True)
    gsutil = os.path.join(bindir, "gsutil")
    with open(gsutil, "w", encoding="utf-8") as f:
        f.write(GSUTIL_STAND_IN)
    os.chmod(gsutil, 0o755)
    env = {"PATH": f"{bindir}:{os.environ.get('PATH', '')}",
           "FAKE_GCS_ROOT": os.path.join(root, "gcs")}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield env["FAKE_GCS_ROOT"]
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _count_calls(fn, names, per_call: list, after=None):
    """`fn` with each call's kernel launches recorded in `per_call` (the
    counts set to 0 just before the call, read just after); `after(out)`
    runs after the read."""
    from tony_tpu_torch.ops import cuda_lib

    def wrapped(*args, **kwargs):
        cuda_lib.reset_launches()
        out = fn(*args, **kwargs)
        per_call.append({n: cuda_lib.launches()[n] for n in names})
        if after is not None:
            after(out)
        return out
    return wrapped


def _ckpt_trainer(flags: list[str], skip: int = 0):
    """(Trainer, model config) as the entry point builds them for
    llama3_1b_proxy at B4 x S4096 with `flags`, its training data advanced
    `skip` batches."""
    from tony_tpu_torch.train.__main__ import build_arg_parser, build_trainer
    args = build_arg_parser().parse_args(
        ["--config", TRAIN_CONFIG, "--device", "cuda", "--batch-size",
         str(TRAIN_BATCH), "--seq-len", str(TRAIN_SEQ), "--log-every", "1",
         *flags])
    trainer, cfg = build_trainer(args)
    for _ in range(skip):
        next(trainer.data_iter)
    return trainer, cfg


def _arm(trainer, cfg, steps: list, evals: list | None = None,
         after_step=None) -> None:
    """Count the set-up Trainer's step (and eval step) launches, per
    call, into `steps` (and `evals`)."""
    want = _step_launches(cfg.n_layers)
    trainer.train_step = _count_calls(trainer.train_step, want, steps,
                                      after_step)
    if evals is not None:
        trainer.eval_step = _count_calls(trainer.eval_step, want, evals)


def _losses(trainer) -> list[float]:
    return [e["loss"] for e in trainer.metrics_history if "loss" in e]


def _interval_s(trainer, step: int) -> float:
    """Host seconds of the log interval that ends at `step` (log_every 1:
    the previous step's device time and this step's issue)."""
    entry = next(e for e in trainer.metrics_history
                 if e.get("step") == step and "tokens_per_s" in e)
    return TRAIN_BATCH * (TRAIN_SEQ + 1) / entry["tokens_per_s"]


def _rel_gap(got: list[float], want: list[float]) -> float:
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def _leaves(trainer) -> list:
    from tony_tpu_torch.train.checkpoint import flatten_with_paths
    return [(path, leaf.detach() if hasattr(leaf, "detach") else leaf)
            for path, leaf in flatten_with_paths(trainer._state())]


def _serve_from_checkpoint(ckpt_dir: str, params, cfg) -> dict[str, int]:
    """`build_server --checkpoint-dir` on the latest step: the served
    parameters equal `params` bit for bit, two prompts' greedy tokens equal
    `generate` on `params`, and the burst's launches are exact. Returns
    them."""
    import numpy as np
    import torch

    from tony_tpu_torch.models.generate import generate
    from tony_tpu_torch.ops import cuda_lib
    from tony_tpu_torch.serve.__main__ import build_arg_parser, build_server
    from tony_tpu_torch.train.optim import tree_leaves

    args = build_arg_parser().parse_args(
        ["--config", TRAIN_CONFIG, "--device", "cuda", "--checkpoint-dir",
         ckpt_dir, "--slots", "1", "--token-budget",
         str(CKPT_PROMPT + CKPT_NEW), "--port", "0", "--host", "127.0.0.1"])
    server = build_server(args)
    engine = server.engine
    try:
        same = all(torch.equal(a, b.detach()) for a, b in zip(
            tree_leaves(engine.params), tree_leaves(params)))
        check(same, "the served parameters differ from the trained ones")
        rng = np.random.RandomState(7)
        prompts = [[int(t) for t in rng.randint(0, cfg.vocab_size,
                                                 size=CKPT_PROMPT)]
                   for _ in range(2)]
        before = dict(engine.snapshot())
        cuda_lib.reset_launches()
        got = [_post(server.url, {"prompt": p, "max_new_tokens": CKPT_NEW},
                     stream=False)["tokens"] for p in prompts]
        after = _settled(engine)
        launches = cuda_lib.launches()
    finally:
        server.stop(drain_timeout=0)
    admissions = after["admissions"] - before["admissions"]
    steps = after["decode_steps"] - before["decode_steps"]
    want_launches = {"flash_fwd": cfg.n_layers * admissions,
                     "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                     "rmsnorm_fwd": (2 * cfg.n_layers + 1)
                     * (admissions + steps), "int8_matmul": 0,
                     "decode_attention": _k6_launches(cfg, steps)}
    log(f"ckpt: served {len(prompts)} prompts of {CKPT_PROMPT} tokens from "
        f"the checkpoint: launches {launches}, expected {want_launches}")
    check(launches == want_launches,
          f"serve-from-checkpoint launches {launches} != {want_launches}")
    for p, tokens in zip(prompts, got):
        want = generate(params, cfg, torch.tensor(
            [p], device=params["embed"].device), CKPT_NEW)[0].tolist()
        log(f"ckpt: served {tokens}, generate {want}")
        check(tokens == want, f"served tokens {tokens} != generate {want}")
    del server, engine
    torch.cuda.empty_cache()
    return launches


def _preemption(root: str) -> None:
    """SIGTERM on `python -m tony_tpu_torch.train` (tiny, on the card)
    after its first step line: exit 12 with the step committed; a rerun
    with two more steps resumes there and exits 0."""
    from tony_tpu_torch.train.checkpoint import latest_step
    repo = str(Path(__file__).resolve().parent)
    d = os.path.join(root, "preempt")
    cmd = [sys.executable, "-m", "tony_tpu_torch.train", "--config", "tiny",
           "--device", "cuda", "--checkpoint-dir", d, "--log-every", "1"]
    env = dict(os.environ, PYTHONPATH=repo)
    proc = subprocess.Popen(cmd + ["--steps", "100000"], cwd=repo, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    timer = threading.Timer(300, proc.kill)
    timer.start()
    try:
        for line in proc.stderr:
            if re.search(r"step \d+ loss", line):
                break
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=300)
    finally:
        timer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    found = re.search(r"preempted at step (\d+)", err)
    log(f"ckpt: SIGTERM after the first step line: exit {proc.returncode}, "
        f"{found.group(0) if found else 'no preemption line'}, latest step "
        f"{latest_step(d)}")
    check(proc.returncode == 12 and found is not None,
          f"preempted trainer exited {proc.returncode}: {err[-2000:]}")
    stopped = int(found.group(1))
    check(latest_step(d) == stopped,
          f"latest step {latest_step(d)} != the step stopped at {stopped}")
    out = subprocess.run(cmd + ["--steps", str(stopped + 2)], cwd=repo,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    last = out.stdout.strip().splitlines()[-1] if out.stdout.strip() else ""
    log(f"ckpt: rerun to step {stopped + 2}: exit {out.returncode}, {last!r}")
    check(out.returncode == 0 and last.startswith("final loss ")
          and f"resuming from checkpoint step {stopped}" in out.stderr
          and latest_step(d) == stopped + 2,
          f"resumed trainer exited {out.returncode}: {out.stderr[-2000:]}")


def _check_restore(b, saved: list, saved_lr: float, tag: str) -> None:
    """The set-up Trainer `b` restored what run A saved: every leaf bit
    for bit, the lr and each parameter's torch step."""
    import torch
    restored = _leaves(b)
    check([p for p, _ in restored] == [p for p, _ in saved],
          f"{tag}: restored tree differs from the saved one")
    differ = [("/".join(p), None) for (p, x), (_, y) in
              zip(restored, saved)
              if not (torch.equal(x, y) if isinstance(x, torch.Tensor)
                      else x == y)]
    lr = b.opt_state.optimizer.param_groups[0]["lr"]
    per_param_step = {float(s["step"]) for s in
                      b.opt_state.optimizer.state.values()}
    log(f"{tag}: restore of step {b.step}: {len(restored)} leaves, "
        f"{len(differ)} differ from what A saved; lr {lr!r} (A's "
        f"{saved_lr!r}); torch step {per_param_step}")
    check(not differ and lr == saved_lr and b.step == CKPT_STEPS
          and per_param_step == {float(CKPT_STEPS)},
          f"{tag}: restore not bitwise: {differ[:5]}, lr {lr} vs "
          f"{saved_lr}")


def _check_b_against_c(b, c_losses: list, c_params: list, bitwise: bool,
                       a_gap: float, tag: str) -> None:
    """Resumed run B's losses and final parameters against the unbroken
    run C: bit for bit when A matched C bit for bit, else within 4x A's
    gap (or 1e-3 relative)."""
    import torch

    from tony_tpu_torch.train.optim import tree_leaves
    b_losses = _losses(b)
    b_params = [t.detach() for t in tree_leaves(b.params)]
    b_gap = _rel_gap(b_losses, c_losses[CKPT_STEPS:])
    b_param_gap = max(float((x.float() - y.float()).abs().max())
                      for x, y in zip(b_params, c_params))
    log(f"{tag}: run B losses {b_losses} vs C {c_losses[CKPT_STEPS:]}: "
        f"loss gap {b_gap:.3e} (relative), final param gap "
        f"{b_param_gap:.3e}")
    if bitwise:
        check(b_losses == c_losses[CKPT_STEPS:]
              and all(torch.equal(x, y) for x, y in zip(b_params, c_params)),
              f"{tag}: A matches C bit for bit, but B does not")
    else:
        limit = max(4 * a_gap, 1e-3)
        check(b_gap <= limit, f"{tag}: B's gap {b_gap} > {limit}")


def _gs_resume(cfg, c_losses: list, c_params: list, bitwise: bool,
               a_gap: float, steps: list, timings: "_Timings", smi: str
               ) -> dict[str, int]:
    """The ckpt phase's resume on gs://chip-smoke/run (inside
    `_gsutil_stand_in`), at the same full width and depth, against the
    same unbroken run C: run A' saves step 2, run B' restores it bit for
    bit and resumes to step 4 saving every step with keep 1,
    retention keeps the pinned step 2 beside step 4, and the server on the
    gs:// checkpoint answers. Returns the served launches."""
    import torch

    from tony_tpu_torch.train.checkpoint import committed_steps
    d = "gs://chip-smoke/run"
    a, _ = _ckpt_trainer(["--steps", str(CKPT_STEPS), "--checkpoint-dir", d])
    a.setup()
    _arm(a, cfg, steps)
    a.run()
    a_losses = _losses(a)
    log(f"ckpt gs: run A' losses {a_losses} (C's first {CKPT_STEPS}: "
        f"{c_losses[:CKPT_STEPS]})")
    check(a_losses == c_losses[:CKPT_STEPS] or not bitwise,
          f"ckpt gs: run A' losses {a_losses} differ from C's")
    check(committed_steps(d) == [CKPT_STEPS],
          f"ckpt gs: run A' left steps {committed_steps(d)}")
    saved = _leaves(a)
    saved_lr = a.opt_state.optimizer.param_groups[0]["lr"]
    del a
    torch.cuda.empty_cache()
    b, _ = _ckpt_trainer(["--steps", str(2 * CKPT_STEPS), "--checkpoint-dir",
                          d, "--checkpoint-every", "1"], skip=CKPT_STEPS)
    b.config.checkpoint_keep = 1
    b.setup()
    _check_restore(b, saved, saved_lr, "ckpt gs")
    del saved
    _arm(b, cfg, steps)
    b.run()
    _check_b_against_c(b, c_losses, c_params, bitwise, a_gap, "ckpt gs")
    check(committed_steps(d) == [CKPT_STEPS, 2 * CKPT_STEPS],
          f"ckpt gs: run B' left steps {committed_steps(d)} (keep 1, "
          f"step {CKPT_STEPS} pinned)")
    log(f"ckpt gs: retention kept steps {committed_steps(d)}; "
        f"{timings.line()} (commit: uploads through the gsutil stand-in, "
        f"a local-disk cp per object, not GCS; restore: fetches the same "
        f"way); {smi}")
    served = _serve_from_checkpoint(d, b.params, cfg)
    del b
    return served


def phase_ckpt(smi: str, keep: bool = False) -> dict[str, int]:
    """Returns each kernel's launches over the phase's training steps,
    evals and served requests. With `keep`, run B's checkpoint directory
    outlives the phase, in KEPT_CKPT."""
    import torch

    from tony_tpu_torch.device import peak_flops
    from tony_tpu_torch.models.llama import llama_loss
    from tony_tpu_torch.train.checkpoint import committed_steps
    from tony_tpu_torch.train.optim import tree_leaves

    root = tempfile.mkdtemp(prefix="chip-smoke-ckpt-")
    timings = _Timings()
    steps: list[dict] = []
    evals: list[dict] = []
    served: dict[str, int] = {}
    try:
        d = os.path.join(root, "run")
        # run A: 2 steps, one held-out batch at step 2, the final save
        a, cfg = _ckpt_trainer(["--steps", str(CKPT_STEPS),
                                "--checkpoint-dir", d, "--eval-every",
                                str(CKPT_STEPS)])
        a.setup()
        state_bytes = sum(t.numel() * t.element_size()
                          for _, t in _leaves(a)
                          if isinstance(t, torch.Tensor))
        free = shutil.disk_usage(root).free
        log(f"ckpt: state {state_bytes / 1e9:.3f} GB (params, AdamW mu and "
            f"nu, counts); {free / 1e9:.1f} GB free under {root}")
        check(free >= CKPT_DISK_COPIES * state_bytes,
              f"{free / 1e9:.1f} GB free under {root}, less than "
              f"{CKPT_DISK_COPIES} x the {state_bytes / 1e9:.2f} GB state "
              f"the phase writes")
        _arm(a, cfg, steps, evals)
        a.run()
        a_losses = _losses(a)
        batch = a._eval_set[0]
        with torch.no_grad():
            direct = float(llama_loss(a.params, batch, cfg))
        eval_gap = abs(a.last_eval_loss - direct) / abs(direct)
        log(f"ckpt: run A losses {a_losses}, eval loss {a.last_eval_loss:.6f}"
            f" vs llama_loss {direct:.6f} (rel {eval_gap:.2e}, tol 1e-3)")
        check(eval_gap <= 1e-3, f"eval loss {a.last_eval_loss} vs {direct}")
        check(committed_steps(d) == [CKPT_STEPS],
              f"run A left steps {committed_steps(d)}")
        saved = _leaves(a)
        saved_lr = a.opt_state.optimizer.param_groups[0]["lr"]
        a_params = [t.detach() for t in tree_leaves(a.params)]
        del a
        torch.cuda.empty_cache()

        # run C: 4 steps uninterrupted; its params after step 2 kept
        c_params2: list = []

        def keep_step2(out):
            if len(c_steps) == CKPT_STEPS:
                c_params2.extend(t.detach().clone()
                                 for t in tree_leaves(out[0]))
        c_steps: list[dict] = []
        c, _ = _ckpt_trainer(["--steps", str(2 * CKPT_STEPS)])
        c.setup()
        _arm(c, cfg, c_steps, after_step=keep_step2)
        c.run()
        steps.extend(c_steps)
        c_losses = _losses(c)
        c_params = [t.detach() for t in tree_leaves(c.params)]
        c_interval = _interval_s(c, 2 * CKPT_STEPS)
        del c
        torch.cuda.empty_cache()
        a_gap = _rel_gap(a_losses, c_losses[:CKPT_STEPS])
        a_param_gap = max(float((x.float() - y.float()).abs().max())
                          for x, y in zip(a_params, c_params2))
        bitwise = a_gap == 0.0 and all(torch.equal(x, y) for x, y in
                                       zip(a_params, c_params2))
        del c_params2, a_params
        log(f"ckpt: run C losses {c_losses}; A vs C at steps 1-"
            f"{CKPT_STEPS}: loss gap {a_gap:.3e} (relative), param gap "
            f"{a_param_gap:.3e}: {'bitwise' if bitwise else 'not bitwise'}")

        # run B: resume A's step 2 on the next batches, save every step
        b, _ = _ckpt_trainer(["--steps", str(2 * CKPT_STEPS),
                              "--checkpoint-dir", d, "--checkpoint-every",
                              "1"], skip=CKPT_STEPS)
        b.config.checkpoint_keep = 1
        b.setup()
        _check_restore(b, saved, saved_lr, "ckpt")
        del saved
        _arm(b, cfg, steps)
        b.run()
        _check_b_against_c(b, c_losses, c_params, bitwise, a_gap, "ckpt")
        check(committed_steps(d) == [CKPT_STEPS, 2 * CKPT_STEPS],
              f"run B left steps {committed_steps(d)}")
        b_interval = _interval_s(b, 2 * CKPT_STEPS)
        log(f"ckpt: {timings.line()} (commit: file writes and rename); the "
            f"interval ending at step {2 * CKPT_STEPS}: {b_interval:.4f} s "
            f"with a save every step, {c_interval:.4f} s without; {smi}")

        served = _serve_from_checkpoint(d, b.params, cfg)
        del b
        if keep:
            # run B's directory (its steps 2 and 4), for the long phase's
            # serving submitter; main removes it at the end
            KEPT_CKPT["root"] = tempfile.mkdtemp(prefix="chip-smoke-kept-")
            KEPT_CKPT["dir"] = shutil.move(d, os.path.join(
                KEPT_CKPT["root"], "run"))
        else:
            shutil.rmtree(d)
        torch.cuda.empty_cache()

        # the same resume on a gs:// directory, through the stand-in
        timings.clear()
        with _gsutil_stand_in(root):
            gs_served = _gs_resume(cfg, c_losses, c_params, bitwise, a_gap,
                                   steps, timings, smi)
        for name, n in gs_served.items():
            served[name] = served.get(name, 0) + n
        del c_params
        torch.cuda.empty_cache()

        # f32 master weights: params are the cast master after every step
        m_steps: list[dict] = []
        cast_ok: list[bool] = []
        m, _ = _ckpt_trainer(["--steps", str(MASTER_STEPS),
                              "--master-weights"])
        m.setup()

        def cast_equal(out):
            params, opt_state, _ = out
            cast_ok.append(all(
                torch.equal(p.detach(), w.detach().to(p.dtype))
                for p, w in zip(tree_leaves(params),
                                tree_leaves(opt_state.master))))
        _arm(m, cfg, m_steps, after_step=cast_equal)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        m.run()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        steps.extend(m_steps)
        m_losses = _losses(m)
        entry = m.metrics_history[-1]
        step_s = _interval_s(m, MASTER_STEPS)
        mfu = entry.get("mfu_pct", 0.0)
        log(f"ckpt: master weights losses {m_losses}; params == cast "
            f"master after each step: {cast_ok}; interval ending at step "
            f"{MASTER_STEPS}: {step_s:.4f} s = {entry['tokens_per_s']:.1f} "
            f"tokens/s, MFU {mfu:.2f}% of "
            f"{peak_flops(torch.device('cuda')) / 1e12:.0f} TFLOP/s; peak "
            f"memory allocated {peak_gib:.2f} GiB (limit {MASTER_PEAK_GIB})")
        check(cast_ok == [True] * MASTER_STEPS,
              f"bf16 params differ from the cast master: {cast_ok}")
        check(all(math.isfinite(x) for x in m_losses), f"losses {m_losses}")
        check(peak_gib <= MASTER_PEAK_GIB,
              f"peak memory {peak_gib:.2f} GiB > {MASTER_PEAK_GIB} GiB")
        del m
        torch.cuda.empty_cache()

        _preemption(root)
    finally:
        timings.close()
        shutil.rmtree(root, ignore_errors=True)
    want = _step_launches(cfg.n_layers)
    eval_want = _forward_launches(cfg.n_layers)
    log(f"ckpt: {len(steps)} steps, launches per step "
        f"{sorted({json.dumps(x, sort_keys=True) for x in steps})} "
        f"(expected {want}); evals {evals} (expected {eval_want})")
    check(all(x == want for x in steps),
          f"a step's launches differ from {want}")
    check(len(evals) == 1 and evals[0] == eval_want,
          f"eval launches {evals} != [{eval_want}]")
    total = dict(served)
    for x in steps + evals:
        for name, n in x.items():
            total[name] = total.get(name, 0) + n
    return total


# ---------------------------------------------------------------------------
# phase 8: the port as a TonY task, reporting to a recording AM
# ---------------------------------------------------------------------------

class _AmStandIn:
    """A recording AM: a gRPC server with generic unary handlers for the
    calls a port task and the port's executor make, speaking the port's
    JSON codec. A call without the task token is refused UNAUTHENTICATED,
    as the AM's interceptor refuses it. Every call is recorded with its
    arrival time; `update_metrics`, `register_serving_endpoint`, results
    and heartbeats are answered {} (heartbeats with the spec generation,
    1). With `gang` set ({jobtype: count}) `register_worker_spec` is the
    gang barrier: it answers the cluster spec of every registered
    host:port once every task of the gang has registered, else no spec;
    `get_cluster_spec` answers the same."""

    def __init__(self, token: str):
        from concurrent import futures

        import grpc

        from tony_tpu_torch.rpc.client import (
            CLUSTER_METHODS, CLUSTER_SERVICE, METRICS_METHODS,
            METRICS_SERVICE, _deser, _ser,
        )
        self.token = token
        self.calls: list[tuple[str, str, dict]] = []
        self.stamps: list[float] = []
        self.gang: dict[str, int] = {}
        self._registered: dict[str, str] = {}
        self._lock = threading.Lock()
        answers = {"register_worker_spec": self._register,
                   "get_cluster_spec": lambda req: {"spec": self._spec()},
                   "task_executor_heartbeat":
                       lambda req: {"spec_generation": 1}}

        def handler(method):
            answer = answers.get(method, lambda req: {})

            def unary(req, ctx):
                meta = dict(ctx.invocation_metadata() or ())
                if meta.get("tony-token") != self.token:
                    ctx.abort(grpc.StatusCode.UNAUTHENTICATED,
                              "missing or invalid tony token")
                with self._lock:
                    self.calls.append((method, meta.get("tony-task-id", ""),
                                       req))
                    self.stamps.append(time.monotonic())
                    return answer(req)
            return grpc.unary_unary_rpc_method_handler(
                unary, request_deserializer=_deser,
                response_serializer=_ser)

        self.server = grpc.server(futures.ThreadPoolExecutor(max_workers=8))
        self.server.add_generic_rpc_handlers((
            grpc.method_handlers_generic_handler(
                CLUSTER_SERVICE, {m: handler(m) for m in CLUSTER_METHODS}),
            grpc.method_handlers_generic_handler(
                METRICS_SERVICE, {m: handler(m) for m in METRICS_METHODS})))
        self.port = self.server.add_insecure_port("127.0.0.1:0")
        self.server.start()

    def _spec(self):
        """The gang's cluster spec as JSON once complete, else None
        (holds: _lock)."""
        spec = {job: [self._registered.get(f"{job}:{i}") for i in range(n)]
                for job, n in self.gang.items()}
        if not self.gang or any(None in v for v in spec.values()):
            return None
        return json.dumps(spec)

    def _register(self, req: dict) -> dict:
        self._registered[req["task_id"]] = req["spec"]
        spec = self._spec()
        return {"spec": spec, "generation": 1} if spec else {"spec": None}

    def set_gang(self, gang: dict[str, int]) -> None:
        """A new gang, with no task registered."""
        with self._lock:
            self.gang = dict(gang)
            self._registered.clear()

    def take(self, method: str) -> list[tuple[str, dict]]:
        with self._lock:
            return [(task, req) for m, task, req in self.calls
                    if m == method]

    def take_timed(self, method: str) -> list[tuple[float, str, dict]]:
        with self._lock:
            return [(t, task, req) for (m, task, req), t
                    in zip(self.calls, self.stamps) if m == method]

    def clear(self) -> None:
        with self._lock:
            self.calls.clear()
            self.stamps.clear()

    def stop(self) -> None:
        self.server.stop(grace=None)


def _task_env(am: "_AmStandIn", job: str, trace_id: str, parent: str,
              conf_path: str) -> dict[str, str]:
    """The environment the executor renders into a task."""
    return {"AM_HOST": "127.0.0.1", "AM_PORT": str(am.port),
            "JOB_NAME": job, "TASK_INDEX": "0", "TASK_ATTEMPT": "0",
            "TONY_TRACE_ID": trace_id, "TONY_PARENT_SPAN": parent,
            "TONY_SECURITY_TOKEN": am.token, "TONY_CONF_PATH": conf_path}


def _write_conf(path: str, values: dict) -> str:
    """A frozen conf file, in the layout the TonY client writes."""
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"values": values, "sources": {k: "chip_smoke"
                                                 for k in values}}, f)
    return path


# the kernels of a profiled step's trace, by the port kernel launching
# each (the trace's demangled names: `void flash_fwd_tc<128>(...)`)
TRACE_KERNELS = {"flash_fwd": r"\bflash_fwd_(tc|kernel)\b",
                 "flash_bwd_dq": r"\bflash_bwd_dq_(tc|kernel)\b",
                 "flash_bwd_dkv": r"\bflash_bwd_dkv_(tc|kernel)\b",
                 "rmsnorm_fwd": r"\brmsnorm_(vec|scalar)\b",
                 "int8_matmul": r"\bw8a16\b",
                 "decode_attention": r"\bdecode_attention<"}
# the orch phase's capture through the profiler page: steps, and the step
# whose data pull fetches the trace (the capture starts at step 1's log
# boundary, so it covers steps 2 and 3)
ORCH_PROFILE_STEPS, ORCH_PROFILE_FETCH = 2, 4


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _listening(port: int) -> bool:
    import socket
    with socket.socket() as s:
        s.settimeout(2)
        return s.connect_ex(("127.0.0.1", port)) == 0


def _trace_kernels(trace: dict) -> dict[str, int]:
    """Device kernel events of a Chrome trace, counted by port kernel."""
    counts = {name: 0 for name in TRACE_KERNELS}
    for e in trace.get("traceEvents", []):
        if e.get("cat") != "kernel":
            continue
        for name, pattern in TRACE_KERNELS.items():
            if re.search(pattern, e.get("name", "")):
                counts[name] += 1
    return counts


def _orch_train(am: "_AmStandIn", root: str, conf_path: str, smi: str
                ) -> dict[str, int]:
    """The `--data` Trainer in this process under the task environment:
    first batch, launches per step, the gauges, goodput and spans the
    stand-in received, stall_s per step, and the step interval. As the
    chief with TB_PORT set it serves the profiler page: a 2-step capture
    requested there, its Chrome trace fetched there during the run, holds
    the port's kernels at the steps' exact launch counts. A task with
    IS_CHIEF=false binds nothing."""
    import numpy as np
    import torch

    from tony_tpu_torch.models.llama import get_config
    from tony_tpu_torch.ops import cuda_lib
    from tony_tpu_torch.train.__main__ import build_arg_parser, build_trainer
    from tony_tpu_torch.train.native_data import (
        XorShiftStarts, write_token_file,
    )

    shard = os.path.join(root, "tokens.bin")
    tokens = np.random.default_rng(0).integers(
        0, get_config(TRAIN_CONFIG).vocab_size, ORCH_SHARD_TOKENS,
        dtype=np.int32)
    write_token_file(shard, tokens)
    parent = "0f" * 8
    env = _task_env(am, "worker", "chip-smoke-train", parent, conf_path)
    tb_port = _free_port()
    env.update(TB_PORT=str(tb_port), IS_CHIEF="true")
    page = f"http://127.0.0.1:{tb_port}"
    profiled: dict = {}
    saved = {k: os.environ.get(k) for k in env}
    cwd = os.getcwd()
    os.environ.update(env)
    # the request file lands in the task's cwd
    os.chdir(root)
    try:
        args = build_arg_parser().parse_args(
            ["--config", TRAIN_CONFIG, "--device", "cuda", "--steps",
             str(ORCH_STEPS), "--batch-size", str(TRAIN_BATCH),
             "--seq-len", str(TRAIN_SEQ), "--log-every", "1",
             "--eval-every", str(ORCH_EVAL_EVERY), "--data", shard,
             "--checkpoint-dir", os.path.join(root, "ckpt")])
        trainer, cfg = build_trainer(args)
        first: list = []
        source = trainer.data_iter

        def recorded():
            for batch in source:
                if not first:
                    first.append(batch["tokens"].copy())
                yield batch

        trainer.data_iter = recorded()
        t_wall = time.monotonic()
        trainer.setup()
        status = json.loads(_http(page + "/")[2])
        ask = _http(page + "/v1/profile", json.dumps(
            {"num_steps": ORCH_PROFILE_STEPS}).encode())
        rid = json.loads(ask[2])["request_id"]
        waiting = _http(f"{page}/v1/profile/{rid}")
        log(f"orch: train: profiler page on TB_PORT {tb_port}: GET / "
            f"{status}; POST /v1/profile {ask[0]} {rid}; GET "
            f"/v1/profile/{rid} {waiting[0]} before the run")
        check(ask[0] == 200 and waiting[0] == 202
              and status["active"] is None,
              f"orch: profiler page answered {status} {ask[0]} {ask[2]!r} "
              f"{waiting[0]}")
        want = _step_launches(cfg.n_layers)
        step_fn = trainer.train_step
        per_step: list[dict[str, int]] = []
        stalls: list[float] = []

        def counted_step(params, opt_state, batch):
            if len(per_step) == ORCH_PROFILE_FETCH - 1:
                code, _, body = _http(f"{page}/v1/profile/{rid}")
                profiled.update(code=code, bytes=len(body),
                                kernels=_trace_kernels(json.loads(body))
                                if code == 200 else {},
                                status=json.loads(_http(page + "/")[2]))
            before = cuda_lib.launches()
            out = step_fn(params, opt_state, batch)
            after = cuda_lib.launches()
            per_step.append({n: after[n] - before[n] for n in want})
            stalls.append(trainer._global_data_iter.stall_s)
            return out

        trainer.train_step = counted_step
        cuda_lib.reset_launches()
        trainer.run()
        wall = time.monotonic() - t_wall
        total = cuda_lib.launches()
        closed = not _listening(tb_port)
    finally:
        os.chdir(cwd)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    want_trace = {n: ORCH_PROFILE_STEPS * k for n, k in want.items()}
    log(f"orch: train: GET /v1/profile/{rid} during step "
        f"{ORCH_PROFILE_FETCH}'s data pull: {profiled.get('code')}, "
        f"{profiled.get('bytes', 0)} bytes of Chrome trace; its kernel "
        f"events {profiled.get('kernels')} (expected {want_trace}: steps 2 "
        f"and 3); GET / then {profiled.get('status')}; the port closed "
        f"after run(): {closed}; {smi}")
    check(profiled.get("code") == 200
          and profiled["kernels"] == want_trace
          and rid in profiled["status"]["captures"] and closed,
          f"orch: the profiler page's capture: {profiled}")
    _not_chief(tb_port)

    # the first batch: a fresh numpy read of the shard at the windows the
    # seed's xorshift64* draws (training seed = process index 0)
    starts = XorShiftStarts(0, ORCH_SHARD_TOKENS - TRAIN_SEQ)
    row = TRAIN_SEQ + 1
    expect = np.stack([tokens[s:s + row] for s in
                       (starts.next() for _ in range(TRAIN_BATCH))])
    check(len(first) == 1 and np.array_equal(first[0], expect),
          "orch: the Trainer's first batch is not the shard's windows at "
          "seed 0")
    log(f"orch: train: the first batch ({first[0].shape}, int32) equals a "
        f"numpy read of the shard at seed 0's window starts "
        f"{[int(r[0]) for r in expect[:, :1]]}... (first tokens)")
    for i, got in enumerate(per_step):
        check(got == want, f"orch: step {i + 1} launches {got} != {want}")
    evals = ORCH_STEPS // ORCH_EVAL_EVERY
    fwd = _forward_launches(cfg.n_layers)
    want_total = {n: ORCH_STEPS * want[n] + evals * fwd[n] for n in want}
    check(total == want_total,
          f"orch: run launches {total} != {want_total}")
    log(f"orch: train: launches per step {per_step[0]} x {ORCH_STEPS} "
        f"and {evals} eval forwards {fwd}: run total {total}")
    deltas = [b - a for a, b in zip([0.0] + stalls[:-1], stalls)]
    log(f"orch: train: stall_s per step "
        f"{', '.join(f'{d:.6f}' for d in deltas)} (total {stalls[-1]:.6f} "
        f"s)")
    losses = [e["loss"] for e in trainer.metrics_history if "loss" in e]
    check(len(losses) == ORCH_STEPS and all(math.isfinite(x)
                                            for x in losses),
          f"orch: losses {losses}")

    # what the stand-in received from the worker task
    pushes = [req for task, req in am.take("update_metrics")
              if task == "worker:0"]
    gauges: dict[str, float] = {}
    spans: list[dict] = []
    for req in pushes:
        check(req.get("task_type") == "worker" and req.get("index") == 0,
              f"orch: push identity {req.get('task_type')}:"
              f"{req.get('index')}")
        for m in req.get("metrics", []):
            gauges[m["name"]] = m["value"]
        spans += req.get("spans") or []
    for name in ("TRAIN_STEP_TIME_MS", "TRAIN_TOKENS_PER_SEC_PER_CHIP",
                 "TRAIN_MFU_PCT", "TPU_HBM_BYTES_IN_USE",
                 "GOODPUT_WALL_SECONDS", "GOODPUT_TRAIN_STEP_SECONDS",
                 "GOODPUT_COMPILE_SECONDS", "GOODPUT_EVAL_SECONDS",
                 "GOODPUT_CHECKPOINT_SAVE_SECONDS"):
        check(name in gauges, f"orch: the AM never received {name}: "
                              f"{sorted(gauges)}")
    phases = {k[len("GOODPUT_"):-len("_SECONDS")].lower(): v
              for k, v in gauges.items()
              if k.startswith("GOODPUT_") and k != "GOODPUT_WALL_SECONDS"}
    phase_sum = sum(phases.values())
    check(abs(phase_sum - wall) <= 0.01 * wall,
          f"orch: goodput phases sum to {phase_sum:.3f} s, the run's wall "
          f"is {wall:.3f} s (more than 1% apart)")
    log(f"orch: train: {len(pushes)} metric pushes; last gauges: step "
        f"{gauges['TRAIN_STEP_TIME_MS']:.1f} ms, "
        f"{gauges['TRAIN_TOKENS_PER_SEC_PER_CHIP']:.1f} tokens/s, MFU "
        f"{gauges['TRAIN_MFU_PCT']:.2f}%, card memory in use "
        f"{gauges['TPU_HBM_BYTES_IN_USE'] / 2**30:.2f} GiB")
    log(f"orch: train: goodput phases sum {phase_sum:.3f} s against a "
        f"wall of {wall:.3f} s (ledger wall "
        f"{gauges['GOODPUT_WALL_SECONDS']:.3f} s); shares: "
        + ", ".join(f"{p} {100 * v / phase_sum:.2f}%"
                    for p, v in sorted(phases.items(), key=lambda x: -x[1])
                    if v > 0))
    by_name = {s["name"]: s for s in spans}
    for name in ("trainer_setup", "first_step", "checkpoint_save"):
        check(name in by_name, f"orch: span {name} not received: "
                               f"{sorted(by_name)}")
        check(by_name[name]["parent_id"] == parent
              and by_name[name]["trace_id"] == "chip-smoke-train",
              f"orch: span {name} not parented under TONY_PARENT_SPAN: "
              f"{by_name[name]}")
    log("orch: train: spans " + ", ".join(
        f"{s['name']} {s['end_ms'] - s['start_ms']} ms" for s in spans)
        + f", each parented under {parent}")

    # steps 3-8: the interval between log boundaries is one step of
    # device time once the loss reads lag one step
    window = [e for e in trainer.metrics_history
              if "tokens_per_s" in e and e["step"] >= 3]
    intervals = sorted(TRAIN_BATCH * (TRAIN_SEQ + 1) / e["tokens_per_s"]
                       for e in window)
    median = (intervals[len(intervals) // 2]
              + intervals[(len(intervals) - 1) // 2]) / 2
    ref = TRAIN_INTERVAL.get("s")
    log(f"orch: train: median interval over steps 3-{ORCH_STEPS} "
        f"{median:.4f} s per step (steps 5 and later hold an eval's "
        f"share); the train phase's in this run: "
        + (f"{ref:.4f} s" if ref else "not run"))
    del trainer, step_fn
    torch.cuda.empty_cache()
    return total


def _not_chief(port: int) -> None:
    """A Trainer set up with TB_PORT and IS_CHIEF=false binds nothing."""
    from tony_tpu_torch.train.__main__ import build_arg_parser, build_trainer
    saved = {k: os.environ.get(k) for k in ("TB_PORT", "IS_CHIEF")}
    os.environ.update(TB_PORT=str(port), IS_CHIEF="false")
    try:
        trainer, _ = build_trainer(build_arg_parser().parse_args(
            ["--config", "tiny", "--device", "cuda", "--steps", "0"]))
        trainer.setup()
        bound = trainer._profiler_server is not None or _listening(port)
        trainer.run()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    log(f"orch: train: with IS_CHIEF=false and TB_PORT {port}, a Trainer's "
        f"setup() binds the port: {bound}")
    check(not bound, "orch: a task that is not the chief bound TB_PORT")


def _server_up(proc, timeout: float) -> str:
    """The url of the server's SERVING_UP line (it fails if the server
    exits or stays silent past `timeout`)."""
    found: dict = {}

    def read() -> None:
        for line in proc.stdout:
            if line.startswith("SERVING_UP "):
                found["url"] = line.split()[1]
                return

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    reader.join(timeout)
    check("url" in found, f"orch: no SERVING_UP within {timeout:.0f} s "
                          f"(exit {proc.poll()})")
    return found["url"]


def _http(url: str, data: bytes = None, headers: dict = None,
          timeout: float = 60.0) -> tuple[int, dict, bytes]:
    rq = urllib.request.Request(url, data=data, headers=headers or {},
                                method="POST" if data is not None else "GET")
    try:
        with urllib.request.urlopen(rq, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _orch_serve_run(kind: str, am: "_AmStandIn", root: str, smi: str
                    ) -> dict:
    """One `python -m tony_tpu_torch.serve` run with the serve phase's
    burst; `kind` "on" (AM, profiler and tracing on) or "off"."""
    import numpy as np

    from tony_tpu_torch.models.llama import get_config
    from tony_tpu_torch.observability.prometheus import (
        CONTENT_TYPE, parse,
    )

    on = kind == "on"
    conf = _write_conf(os.path.join(root, f"conf-{kind}.json"), {
        "tony.profiler.enabled": on, "tony.serving.trace.enabled": on,
        # every burst request is kept, so /v1/traces must hold them all
        "tony.serving.trace.slow-threshold-ms": 0,
        "tony.serving.trace.slowest-k": 64,
        "tony.task.metrics-interval-ms": 1000,
        "tony.serving.slots": 4, "tony.serving.token-budget": 2048})
    repo = str(Path(__file__).resolve().parent)
    env = {k: v for k, v in os.environ.items()
           if k not in ("AM_HOST", "AM_PORT", "METRICS_RPC_PORT",
                        "JOB_NAME", "TONY_SECURITY_TOKEN",
                        "TONY_TRACE_ID", "TONY_PARENT_SPAN")}
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    env["TONY_CONF_PATH"] = conf
    if on:
        env.update(_task_env(am, "serving", "chip-smoke-serve", "1e" * 8,
                             conf))
    am.clear()
    err_path = os.path.join(root, f"serve-{kind}.stderr")
    with open(err_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "tony_tpu_torch.serve", "--config",
             SERVE_CONFIG, "--port", "0", "--host", "127.0.0.1"],
            stdout=subprocess.PIPE, stderr=err, text=True, env=env,
            cwd=repo)
    try:
        t0 = time.monotonic()
        url = _server_up(proc, ORCH_SERVER_UP_S)
        up_s = time.monotonic() - t0
        warm = _post(url, {"prompt": [1, 2, 3, 4, 5, 6, 7, 8],
                           "max_new_tokens": 4}, stream=False)
        check(len(warm["tokens"]) == 4, f"orch: warm-up {warm}")
        rng = np.random.RandomState(0)
        vocab = get_config(SERVE_CONFIG).vocab_size
        prompts = [[int(t) for t in rng.randint(0, vocab, size=n)]
                   for n in PROMPT_LENS]
        results: dict[int, object] = {}

        def run(i: int) -> None:
            try:
                results[i] = _post(url, {"prompt": prompts[i],
                                         "max_new_tokens": MAX_NEW},
                                   stream=i < N_STREAMED)
            except Exception as e:  # noqa: BLE001 — reported below
                results[i] = e

        t_burst = time.monotonic()
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        burst_s = time.monotonic() - t_burst
        for i, n in enumerate(PROMPT_LENS):
            r = results.get(i)
            check(isinstance(r, dict) and len(r["tokens"]) == MAX_NEW,
                  f"orch: {kind} request {i} (prompt {n}): {r!r}")
        snap = json.loads(_http(url + "/v1/metrics")[2])
        code, headers, body = _http(url + "/metrics")
        text = body.decode("utf-8")
        parsed = parse(text)
        check(code == 200 and headers.get("Content-Type") == CONTENT_TYPE,
              f"orch: /metrics {code} {headers.get('Content-Type')}")
        overhead = [v for (n, _), v in parsed.items()
                    if n == "tony_profiler_overhead_pct"]
        out = {"kind": kind, "up_s": up_s,
               "tokens_per_s": len(PROMPT_LENS) * MAX_NEW / burst_s,
               "decode_p50_ms": snap["decode_ms_per_token_p50"],
               "itl_p50_ms": snap["itl_p50_ms"],
               "ttft_p50_ms": 1000.0 * snap["ttft_p50_s"],
               "overhead_pct": overhead[0] if overhead else None}
        if on:
            _orch_checks_on(am, url, parsed, text)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        check(rc == 0, f"orch: {kind} server exited {rc} after SIGTERM")
        regs = am.take("register_serving_endpoint")
        if on:
            check([r.get("draining", False) for _, r in regs]
                  == [False, True]
                  and all(r["url"] == url and t == "serving:0"
                          for t, r in regs),
                  f"orch: registrations {regs}")
            log(f"orch: serve on: SIGTERM re-registered {url} with "
                f"draining=True; the server exited 0")
        else:
            check(not am.calls, f"orch: an off run reached the AM: "
                                f"{am.calls[:2]}")
        log(f"orch: serve {kind}: {out['tokens_per_s']:.1f} tokens/s, "
            f"decode p50 {out['decode_p50_ms']:.2f} ms/token, ITL p50 "
            f"{out['itl_p50_ms']:.2f} ms per decode step, TTFT p50 "
            f"{out['ttft_p50_ms']:.1f} ms, profiler overhead "
            + (f"{out['overhead_pct']:.4f}%" if out["overhead_pct"]
               is not None else "not running")
            + f" (up in {up_s:.1f} s; {smi})")
        return out
    except BaseException:
        with open(err_path) as f:
            log(f"orch: {kind} server log tail:\n{f.read()[-3000:]}")
        raise
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def _orch_checks_on(am: "_AmStandIn", url: str, parsed: dict,
                    text: str) -> None:
    """An "on" run: the AM has the registration and the serving pushes,
    /metrics is the port's encoder's exposition of the engine, /v1/traces
    holds the burst, /v1/drain takes the token."""
    regs = am.take("register_serving_endpoint")
    check(len(regs) == 1 and regs[0][1] == {"task_id": "serving:0",
                                             "url": url, "role": "both"},
          f"orch: registration {regs}")
    from tony_tpu_torch.observability.prometheus import parse, render
    check(text.endswith("\n") and "# TYPE tony_serving_tokens_emitted gauge"
          in text, "orch: /metrics lacks the engine's families")
    labels = dict(next(ls for (n, ls) in parsed
                       if n == "tony_serving_tokens_emitted"))
    check(labels == {"task_type": "serving", "index": "0", "attempt": "0"},
          f"orch: engine gauge labels {labels}")
    # the port's encoder re-renders every parsed sample to the same
    # sample lines the server sent (NaN for a gauge with no value yet)
    lines = render([{"name": n, "type": "untyped",
                     "samples": [(dict(ls), v)]}
                    for (n, ls), v in parsed.items()]).splitlines()
    sent = [x for x in text.splitlines() if x and not x.startswith("#")]
    check(sorted(x for x in lines if not x.startswith("#")) == sorted(sent)
          and parse("\n".join(lines)).keys() == parsed.keys(),
          "orch: /metrics is not the port's exposition format")
    deadline = time.monotonic() + 30
    while True:
        pushes = [req for _, req in am.take("update_metrics")]
        names = {m["name"] for req in pushes for m in req["metrics"]}
        traced = sum(len(req.get("serving_traces") or []) for req in pushes)
        if ("SERVING_TOKENS_PER_SEC" in names and traced
                and any(req.get("spans") for req in pushes)):
            break
        check(time.monotonic() < deadline,
              f"orch: no serving push with gauges, traces and spans: "
              f"{sorted(names)}, {traced} traces")
        time.sleep(0.5)
    traces = json.loads(_http(url + "/v1/traces")[2])
    burst = [t for t in traces["traces"]]
    # the reporter drains the ring into its pushes while this runs: each
    # request's trace is in the ring read or in a push, which may land
    # after the read; counted once by its (trace id, request id)

    def trace_ids(reqs) -> set:
        return {(t.get("trace_id"), t.get("request_id")) for req in reqs
                for t in req.get("serving_traces") or []}

    seen = trace_ids(pushes) | trace_ids([{"serving_traces": burst}])
    deadline = time.monotonic() + 10
    while (len(seen) < len(PROMPT_LENS) + 1
           and time.monotonic() < deadline):
        time.sleep(0.5)
        pushes = [req for _, req in am.take("update_metrics")]
        seen |= trace_ids(pushes)
    traced = len(seen) - len(burst)
    check(len(seen) >= len(PROMPT_LENS) + 1
          and traces["http_requests"].get("/v1/generate")
          == len(PROMPT_LENS) + 1,
          f"orch: /v1/traces holds {len(burst)} traces (drained "
          f"{traced}), counts {traces['http_requests']}")
    code, _, _ = _http(url + "/v1/drain", data=b"")
    check(code == 403, f"orch: /v1/drain without the token answered {code}")
    code, _, body = _http(url + "/v1/drain", data=b"",
                          headers={"Authorization": f"Bearer {am.token}"})
    check(code == 200 and json.loads(body)["draining"] is True,
          f"orch: /v1/drain with the token answered {code} {body[:200]}")
    log(f"orch: serve on: the AM got the registration, "
        f"{len(pushes)} pushes ({sorted(n for n in names if 'TTFT' in n)}"
        f", {traced} traces); /metrics parsed {len(parsed)} samples; "
        f"/v1/traces {len(burst)} held, counts {traces['http_requests']}; "
        f"/v1/drain 403 without the token, 200 with it")


def phase_orch(smi: str) -> dict[str, int]:
    """The port as a TonY task (its AM is the stand-in above): training
    on a token shard in this process, then four runs of the server as a
    subprocess, reports off, on, off, on. Returns the training run's
    kernel launches (the server's are another process's)."""
    import secrets

    import grpc  # noqa: F401 — the stand-in needs it; fail here if absent

    root = tempfile.mkdtemp(prefix="chip-smoke-orch-")
    am = _AmStandIn(secrets.token_hex(32))
    log(f"orch: AM stand-in on 127.0.0.1:{am.port} (grpc "
        f"{sys.modules['grpc'].__version__}); {smi}")
    try:
        launches = _orch_train(am, root, _write_conf(
            os.path.join(root, "conf-train.json"),
            {"tony.task.metrics-interval-ms": 1000}), smi)
        runs = [_orch_serve_run(kind, am, root, smi)
                for kind in ORCH_SERVE_RUNS]
    finally:
        am.stop()
        shutil.rmtree(root, ignore_errors=True)
    for key, label in (("tokens_per_s", "tokens/s"),
                       ("decode_p50_ms", "decode p50 ms/token"),
                       ("ttft_p50_ms", "TTFT p50 ms")):
        off = [r[key] for r in runs if r["kind"] == "off"]
        on = [r[key] for r in runs if r["kind"] == "on"]
        spread = abs(off[0] - off[1])
        gap = (sum(off) - sum(on)) / 2 if key == "tokens_per_s" \
            else (sum(on) - sum(off)) / 2
        verdict = ("on slower than off by more than the off-off spread"
                   if gap > spread else "within the off-off spread")
        log(f"orch: {label}: off {off[0]:.2f} / {off[1]:.2f}, on "
            f"{on[0]:.2f} / {on[1]:.2f}; on's cost {gap:+.2f} against "
            f"the off-off spread {spread:.2f}: {verdict} ({smi})")
    return launches


# ---------------------------------------------------------------------------
# phase 9: the mixture-of-experts Llama, served and trained
# ---------------------------------------------------------------------------

def _moe_exact_streams(params, cfg, prompts) -> None:
    """The engine at `generate`'s own shapes (one slot, a budget of prompt
    + new tokens, so its decode steps are generate's B 1 products): each
    prompt's greedy stream equal to offline `generate`, token for
    token."""
    import torch

    from tony_tpu_torch.models.generate import generate
    from tony_tpu_torch.serve.engine import ContinuousBatchingEngine

    for p in prompts:
        engine = ContinuousBatchingEngine(params, cfg, n_slots=1,
                                          token_budget=len(p) + MAX_NEW)
        h = engine.submit(p, MAX_NEW)
        for _ in range(4 * MAX_NEW):
            if h.done.is_set():
                break
            engine.step()
        want = generate(params, cfg, torch.tensor([p], device="cuda"),
                        MAX_NEW)[0].tolist()
        log(f"moe: engine at generate's shapes, prompt {len(p)}: "
            f"{h.tokens}, generate {want}")
        check(h.tokens == want, f"MoE engine stream {h.tokens} != offline "
                                f"generate {want} (prompt {len(p)})")


@contextlib.contextmanager
def _moe_routes(replay: list | None = None):
    """Records every MoE routing in the block (yields the list); with
    `replay`, each call returns the recorded routing of the same call
    instead of its own (the int8 model on the bf16 model's choices)."""
    from tony_tpu_torch.models import moe

    own = moe.route
    seen: list = []

    def route(xt, router, config):
        r = own(xt, router, config) if replay is None else replay[len(seen)]
        seen.append(r)
        return r
    moe.route = route
    try:
        yield seen
    finally:
        moe.route = own


def _choice_flips(a: list, b: list) -> tuple[int, int]:
    """(token-layer routings whose top-k sets differ, all of them) between
    two runs' records."""
    import torch
    flips = total = 0
    for ra, rb in zip(a, b):
        sa = torch.stack(ra.topk_idx, -1).sort(-1).values
        sb = torch.stack(rb.topk_idx, -1).sort(-1).values
        flips += int((sa != sb).any(-1).sum())
        total += sa.shape[0]
    return flips, total


def _moe_serve_checks(server, prompts, finished) -> None:
    """After the bf16 burst, on the served parameters: the burst's streams
    against offline `generate` (compared and printed), the streams at
    generate's shapes (held), the prefill's last logits against
    `moe_forward`, the prefill and decode step profiled with the MoE
    breakdown, then int8: weights quantized on the card, logits against
    bf16's under the 5% gate, K5's launches per decode step exact, and the
    decode step's device time against bf16's."""
    import torch

    from tony_tpu_torch.models.generate import (
        decode_step, empty_cache, generate, prefill,
    )
    from tony_tpu_torch.models.moe import MoEConfig, moe_forward
    from tony_tpu_torch.models.quant import quantize_params, quantized_bytes
    from tony_tpu_torch.ops import cuda_lib
    from tony_tpu_torch.ops.int8_matmul import INT8_MATMUL

    engine = server.engine
    params, cfg = engine.params, engine.config
    check(isinstance(cfg, MoEConfig)
          and cfg.capacity_factor == cfg.n_experts / cfg.top_k,
          f"the served config is not the no-drop MoE config: {cfg}")
    device = torch.device("cuda")
    equal = 0
    by_len = {len(h.prompt): h for h in finished}
    for p in prompts:
        want = generate(params, cfg, torch.tensor([p], device=device),
                        MAX_NEW)[0].tolist()
        got = by_len[len(p)].tokens
        same = got == want
        equal += same
        log(f"moe: burst request, prompt {len(p)}: stream equal to offline "
            f"generate {same}" + ("" if same else
                                  f": served {got} generate {want}"))
    log(f"moe: {equal} of {len(prompts)} burst streams equal offline "
        f"generate (4-slot decode steps against generate's 1-row ones)")
    _moe_exact_streams(params, cfg,
                       [p for p in prompts if len(p) in MOE_EXACT_PROMPTS])

    fwd_prompt = next(p for p in prompts if len(p) == MOE_FORWARD_PROMPT)
    tokens = torch.tensor([fwd_prompt], device=device)
    with torch.inference_mode():
        last, _ = prefill(params, tokens, cfg, len(fwd_prompt))
        full, aux = moe_forward(params, tokens, cfg)
    err, ok = max_err(last, full[:, -1], TOL["bfloat16"])
    log(f"moe: prefill last logits against moe_forward (prompt "
        f"{len(fwd_prompt)}): max_abs_err {err:.3e} (tol "
        f"{TOL['bfloat16']}), aux loss {float(aux):.4f}")
    check(ok and bool(torch.isfinite(full).all()),
          f"MoE prefill logits differ from moe_forward by {err}")

    g = torch.Generator(device="cuda").manual_seed(11)
    long_prompt = torch.randint(0, cfg.vocab_size, (1, PROMPT_LENS[-1]),
                                generator=g, device="cuda")
    cache = empty_cache(cfg, DECODE_SLOTS, DECODE_BUDGET, device)
    rows = {n: a[:, 0:1] for n, a in cache.items()}
    tok = torch.randint(0, cfg.vocab_size, (DECODE_SLOTS,), generator=g,
                        device="cuda")
    pos = torch.tensor(DECODE_POS, device="cuda")
    with torch.inference_mode():
        _profile_step(f"prefill {PROMPT_LENS[-1]} tokens, bf16",
                      lambda: prefill(params, long_prompt, cfg,
                                      DECODE_BUDGET, cache=rows),
                      "moe", cfg.n_experts)
        bf16 = _profile_step(f"decode step, {DECODE_SLOTS} slots, bf16",
                             lambda: decode_step(params, cfg, cache, tok,
                                                 pos),
                             "moe", cfg.n_experts)

    t0 = time.monotonic()
    with torch.inference_mode():
        qparams = quantize_params(params)
    torch.cuda.synchronize()
    now, full_bytes = quantized_bytes(qparams)
    log(f"moe: quantized on the card in {time.monotonic() - t0:.1f} s: "
        f"{now / 1e9:.3f} GB of int8 weights and scales where bf16 holds "
        f"{full_bytes / 1e9:.3f} GB (the router stays "
        f"{str(qparams['layers']['router'].dtype).split('.')[-1]})")
    b, p = QUANT_PROMPTS
    qtokens = torch.randint(0, cfg.vocab_size, (b, p), generator=g,
                            device="cuda")
    # the 5% gate holds the int8 products' error: the int8 model routed as
    # the bf16 model routed. On its own routing a token whose top-2 margin
    # is below the int8 perturbation of its router input takes another
    # expert, and its logits then differ by a whole expert's output: that
    # is printed beside it, with the choices that differ
    errs = {}
    with torch.inference_mode():
        with _moe_routes() as bf16_routes:
            ref, ref_cache = prefill(params, qtokens, cfg, p + 8)
            nxt = torch.argmax(ref, dim=-1)
            d_ref, _ = decode_step(params, cfg, ref_cache, nxt, p)
        for mode, qc in (("int8 weights", False),
                         ("int8 weights + int8 cache", True)):
            for routing, replay in (("own routing", None),
                                    ("bf16's routing", bf16_routes)):
                with _moe_routes(replay) as routes:
                    logits, qcache = prefill(qparams, qtokens, cfg, p + 8,
                                             quant_cache=qc)
                    d, _ = decode_step(qparams, cfg, qcache, nxt, p)
                check(bool(torch.isfinite(d).all()), f"MoE {mode} logits")
                flips, total = _choice_flips(routes, bf16_routes)
                rows = [round(_nrmse(logits[i], ref[i]), 4)
                        for i in range(b)]
                errs[mode, routing] = (_nrmse(logits, ref), _nrmse(d, d_ref))
                log(f"moe: {mode}, {routing}: normalized RMSE against "
                    f"bf16: prefill {errs[mode, routing][0]:.4f} (by prompt "
                    f"{rows}), decode {errs[mode, routing][1]:.4f}; "
                    f"top-{cfg.top_k} choices differing from bf16's in "
                    f"{flips} of {total} token-layers")
    for (mode, routing), (e_pre, e_dec) in errs.items():
        if routing == "bf16's routing":
            check(e_pre < QUANT_NRMSE and e_dec < QUANT_NRMSE,
                  f"MoE {mode} logits on bf16's routing: normalized RMSE "
                  f"{e_pre}, {e_dec} (limit {QUANT_NRMSE})")
        cuda_lib.reset_launches()
        decode_step(qparams, cfg, cache, tok, pos)
        k5 = cuda_lib.launches()[INT8_MATMUL.name]
    want_k5 = _k5_per_pass(cfg, DECODE_SLOTS)
    log(f"moe: K5 launches in one int8 decode step of {DECODE_SLOTS} slots: "
        f"{k5}, expected {want_k5} ({cfg.n_layers} layers x (4 attention "
        f"products + 3 expert banks of {cfg.n_experts}) + the LM head)")
    check(k5 == want_k5, f"int8 decode step K5 launches {k5} != {want_k5}")
    with torch.inference_mode():
        int8 = _profile_step(f"decode step, {DECODE_SLOTS} slots, int8 "
                             f"weights", lambda: decode_step(
                                 qparams, cfg, cache, tok, pos),
                             "moe", cfg.n_experts)
    log(f"moe: decode step device busy bf16 {bf16['busy_ms']:.2f} ms "
        f"({bf16['ops']} ops, wall {bf16['wall_ms']:.2f} ms), int8 weights "
        f"{int8['busy_ms']:.2f} ms ({int8['ops']} ops, wall "
        f"{int8['wall_ms']:.2f} ms, K5 {int8['k5_ms']:.2f} ms)")
    del qparams, cache, rows, ref_cache
    torch.cuda.empty_cache()


def _moe_repeat(first_losses: list[float]) -> dict[str, int]:
    """Two fresh `Trainer.run()`s of MOE_REPEAT_STEPS steps, built as the
    entry point builds them: their losses equal bit for bit each other's
    and the first steps' of the train run, and so do every parameter and
    AdamW moment (the moments hold each step's gradients: a backward that
    added in another order would show there). Returns their launches."""
    import torch

    from tony_tpu_torch.ops import cuda_lib
    from tony_tpu_torch.train.__main__ import build_arg_parser, build_trainer
    from tony_tpu_torch.train.optim import tree_leaves

    args = build_arg_parser().parse_args(
        ["--config", MOE_CONFIG, "--device", "cuda", "--steps",
         str(MOE_REPEAT_STEPS), "--batch-size", str(MOE_TRAIN_BATCH),
         "--seq-len", str(TRAIN_SEQ), "--log-every", "1"])
    runs = []
    cuda_lib.reset_launches()
    for _ in range(2):
        trainer, _ = build_trainer(args)
        trainer.run()
        losses = [e["loss"] for e in trainer.metrics_history]
        for p in tree_leaves(trainer.params):
            p.grad = None
        runs.append((losses, _leaves(trainer)))
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    launches = cuda_lib.launches()
    (a_losses, a), (b_losses, b) = runs
    log(f"moe: repeat runs of {MOE_REPEAT_STEPS} steps: losses {a_losses} "
        f"and {b_losses}; the train run's first {first_losses}")
    check(a_losses == b_losses == first_losses,
          f"repeat losses differ: {a_losses}, {b_losses}, {first_losses}")
    differ = [("/".join(pa)) for (pa, x), (_, y) in zip(a, b)
              if not (torch.equal(x, y) if isinstance(x, torch.Tensor)
                      else x == y)]
    log(f"moe: repeat runs: {len(a)} leaves (params, AdamW mu and nu, "
        f"counts, step), {len(differ)} differ")
    check(not differ, f"repeat runs differ at {differ[:8]}")
    return launches


def phase_moe() -> dict[str, int]:
    """mixtral_proxy (full width and depth, bf16, random weights from the
    fixed seed) through both entry points: the serve phase's burst on a
    `--config mixtral_proxy` server (no-drop capacity) with its checks in
    `_moe_serve_checks`, the same burst on a `--quant int8 --quant-cache`
    server, then training: the train phase's run at MOE_TRAIN_BATCH and
    two repeat runs. Returns each kernel's launches over the bursts and
    the training steps."""
    import torch

    total: dict[str, int] = {}

    def add(counts: dict[str, int]) -> None:
        for name, n in counts.items():
            total[name] = total.get(name, 0) + n
        # what earlier parts and phases left in reference cycles (a
        # Trainer and its wrapped step) goes before the next part's
        # memory is read
        gc.collect()
        torch.cuda.empty_cache()

    add({})
    add(phase_serve(MOE_CONFIG, tag="moe", hold=_moe_serve_checks))
    add(phase_serve(MOE_CONFIG, ("--quant", "int8", "--quant-cache"),
                    "moe int8"))
    run = _train_run(MOE_CONFIG, MOE_TRAIN_BATCH, MOE_TRAIN_PEAK_GIB,
                     "moe train")
    add(run["launches"])
    repeat = _moe_repeat(run["losses"][:MOE_REPEAT_STEPS])
    from tony_tpu_torch.models.moe import get_moe_config
    want = {name: 2 * MOE_REPEAT_STEPS * n for name, n in
            _step_launches(get_moe_config(MOE_CONFIG).n_layers).items()}
    log(f"moe: repeat runs' launches {repeat}, expected {want}")
    check(repeat == want, f"repeat launches {repeat} != {want}")
    add(repeat)
    torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# phase 10: the parallel layer on one card
# ---------------------------------------------------------------------------

# (a) the train phase's model and batch, PARALLEL_STEPS steps: in this
# process on plain tensors, then `python -m tony_tpu_torch.train` on an
# NCCL world of one with a (fsdp 1, tp 1) mesh
PARALLEL_STEPS = 5
PARALLEL_MESH = {"TPU_MESH_SHAPE": "1,1", "TPU_MESH_AXES": "fsdp,tp"}
# (b) llama3_1b_proxy's attention at the train phase's shape, causal, the
# sequence over SP_RANKS virtual ranks
SP_SHAPE = (4, 16, 8, 4096, 128)
SP_RANKS = 4


def _step_seconds(elapsed: list[float]) -> float:
    """The median step interval over steps 3..PARALLEL_STEPS, from the
    Trainer's log boundaries (log_every 1: in steady state the host waits
    one step of device time between two)."""
    gaps = [b - a for a, b in zip(elapsed[1:], elapsed[2:])]
    return sorted(gaps)[len(gaps) // 2]


def _checkpoint_params(step_dir: str) -> dict:
    """{params key path: the shard file's array (mmap)} of a one-process
    checkpoint."""
    import numpy as np
    with open(os.path.join(step_dir, "tree.json")) as f:
        paths = json.load(f)["paths"]
    with open(os.path.join(step_dir, "manifest_p0.json")) as f:
        files = {r["leaf"]: r["file"] for r in json.load(f)["shards"]}
    return {tuple(p[1:]): np.load(os.path.join(step_dir, "shards",
                                               files[i]), mmap_mode="r")
            for i, p in enumerate(paths) if p[0] == "params"}


def _plain_run(flags: list[str]) -> tuple[list[float], float, dict]:
    """The entry point's Trainer (`flags`) in this process on the card, on
    plain tensors: (its losses, its median step, its final parameters on
    the host by key path)."""
    import torch

    from tony_tpu_torch.train.__main__ import build_arg_parser, build_trainer
    from tony_tpu_torch.train.checkpoint import flatten_with_paths

    trainer, _ = build_trainer(build_arg_parser().parse_args(
        flags + ["--device", "cuda"]))
    trainer.run()
    check(trainer.mesh is None, "the plain run built a mesh")
    losses = [e["loss"] for e in trainer.metrics_history]
    step = _step_seconds([e["elapsed_s"] for e in trainer.metrics_history])
    params = {path: leaf.detach().cpu() for path, leaf in
              flatten_with_paths(trainer.params)}
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return losses, step, params


def _mesh_run(flags: list[str], mesh_env: dict, needles: tuple,
              ckpt_dir: str = "") -> dict:
    """`python -m tony_tpu_torch.train` (`flags`) on an NCCL world of one
    with the mesh of `mesh_env`: its log must hold each of `needles` and
    no gloo group. Returns {"losses", "step" (median), "launches" (its own
    count), "wall"}."""
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent),
               TONY_LOG_PLAIN="1", WORLD="1", RANK="0",
               INIT_METHOD=f"tcp://127.0.0.1:{_free_port()}", **mesh_env)
    t0 = time.monotonic()
    out = subprocess.run(
        [sys.executable, "-m", "tony_tpu_torch.train", *flags]
        + (["--checkpoint-dir", ckpt_dir] if ckpt_dir else []),
        capture_output=True, text=True, env=env, timeout=600)
    wall = time.monotonic() - t0
    err = out.stderr
    check(out.returncode == 0, f"mesh run exit {out.returncode}: "
          f"{err[-3000:]}")
    for needle in ("init_process_group(nccl",) + needles:
        check(needle in err, f"the mesh run never logged {needle!r}")
    check("gloo" not in err, "a gloo group on the card")
    steps = [re.search(r"step (\d+) loss (\S+) \((\S+)s\)", line)
             for line in err.splitlines()]
    steps = [m for m in steps if m]
    return {"losses": [float(m.group(2)) for m in steps],
            "step": _step_seconds([float(m.group(3)) for m in steps]),
            "launches": json.loads(re.search(r"kernel launches (\{.*\})",
                                             err).group(1)),
            "wall": wall}


def _bitwise_params(ckpt_dir: str, plain: dict) -> None:
    """The mesh run's checkpointed parameters equal the plain run's
    `plain` bit for bit."""
    import numpy as np
    import torch

    saved = _checkpoint_params(ckpt_dir)
    check(set(saved) == set(plain), f"param paths {sorted(saved)}")
    differ = [path for path, leaf in plain.items() if not np.array_equal(
        np.asarray(saved[path]).view(np.int16 if leaf.dtype ==
                                     torch.bfloat16 else np.int32),
        leaf.view(torch.int16 if leaf.dtype == torch.bfloat16
                  else torch.int32).numpy())]
    check(not differ, f"final parameters differ from the plain run's: "
          f"{differ}")


def _parallel_world_of_one(root: str) -> dict[str, int]:
    """(a): the plain run's losses, final parameters and step time against
    the mesh run's. Returns the mesh run's kernel launches."""
    flags = ["--config", TRAIN_CONFIG, "--steps", str(PARALLEL_STEPS),
             "--batch-size", str(TRAIN_BATCH), "--seq-len", str(TRAIN_SEQ),
             "--log-every", "1"]
    plain_losses, plain_step, plain = _plain_run(flags)
    ckpt_dir = os.path.join(root, "mesh")
    run = _mesh_run(flags, PARALLEL_MESH, (
        "mesh: {'fsdp': 1, 'tp': 1}", "params: 12 DTensor leaves"),
        ckpt_dir)
    mesh_losses, launches = run["losses"], run["launches"]
    log(f"parallel: {TRAIN_CONFIG} B{TRAIN_BATCH} x S{TRAIN_SEQ}, "
        f"{PARALLEL_STEPS} steps: plain losses "
        f"{[f'{x:.9g}' for x in plain_losses]}; NCCL world of one, mesh "
        f"{PARALLEL_MESH}: losses {[f'{x:.9g}' for x in mesh_losses]} "
        f"(subprocess wall {run['wall']:.1f} s, launches {launches})")
    check([f"{x:.9g}" for x in plain_losses]
          == [f"{x:.9g}" for x in mesh_losses],
          "the mesh run's losses are not the plain run's bit for bit")
    _bitwise_params(os.path.join(ckpt_dir, f"step_{PARALLEL_STEPS}"), plain)
    log(f"parallel: final parameters of both runs bit for bit "
        f"({len(plain)} leaves); median step (steps 3-{PARALLEL_STEPS}) "
        f"plain {plain_step:.4f} s, NCCL mesh of one {run['step']:.4f} s "
        f"(+{100 * (run['step'] / plain_step - 1):.2f}%)")
    want = {name: PARALLEL_STEPS * n for name, n in
            _step_launches(16).items()}
    got = {name: launches.get(name, 0) for name in want}
    check(got == want, f"mesh run launches {got} != {want}")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    return got


def _sp_ring(q, k, v, g, scale: float, n: int):
    """The ring's per-chunk arithmetic for n virtual ranks in one process:
    `parallel/ring.py`'s own `_chunk_mode`, `_chunk_forward`,
    `merge_partials` and `_chunk_backward`, the rotations done by index
    (each K/V chunk a contiguous buffer, as it arrives), the dK/dV
    partials summed per chunk as they travel. Returns (out, lse, dq, dk,
    dv) over the whole sequence."""
    import torch

    from tony_tpu_torch.ops.attention import NEG_INF, attention_delta
    from tony_tpu_torch.parallel import ring

    s = q.shape[2] // n

    def chunk(x, i):
        return x[:, :, i * s:(i + 1) * s]

    kc = [chunk(k, i).contiguous() for i in range(n)]
    vc = [chunk(v, i).contiguous() for i in range(n)]
    outs, lses = [], []
    for me in range(n):
        out = torch.zeros(chunk(q, me).shape, dtype=torch.float32,
                          device=q.device)
        lse = torch.full(out.shape[:3], NEG_INF, dtype=torch.float32,
                         device=q.device)
        for t in range(n):
            src = (me - t) % n
            part = ring._chunk_forward(chunk(q, me), kc[src], vc[src],
                                       ring._chunk_mode(src, me, True),
                                       scale)
            if part is not None:
                out, lse = ring.merge_partials(out, lse, *part)
        outs.append(out.to(q.dtype))
        lses.append(lse)
    dqs = []
    dk = [torch.zeros(x.shape, dtype=torch.float32, device=q.device)
          for x in kc]
    dv = [torch.zeros(x.shape, dtype=torch.float32, device=q.device)
          for x in vc]
    for me in range(n):
        gm = chunk(g, me)
        delta = attention_delta(gm, outs[me])
        dq = torch.zeros(outs[me].shape, dtype=torch.float32,
                         device=q.device)
        for t in range(n):
            src = (me - t) % n
            part = ring._chunk_backward(chunk(q, me), kc[src], vc[src],
                                        outs[me], lses[me], delta, gm,
                                        ring._chunk_mode(src, me, True),
                                        scale)
            if part is not None:
                dq.add_(part[0])
                dk[src].add_(part[1])
                dv[src].add_(part[2])
        dqs.append(dq.to(q.dtype))
    return (torch.cat(outs, 2), torch.cat(lses, 2), torch.cat(dqs, 2),
            torch.cat(dk, 2).to(k.dtype), torch.cat(dv, 2).to(v.dtype))


def _sp_ulysses(q, k, v, g, scale: float, n: int):
    """Ulysses' local attention for n virtual ranks in one process: after
    the GQA broadcast each rank's H / n heads of the whole sequence
    through K1 (and K2/K3), the all-to-alls done as head slices. Returns
    (out, lse, dq, dk, dv), dk and dv summed back to the narrow K/V
    heads."""
    import torch

    from tony_tpu_torch.ops.attention import (
        _gqa_broadcast, _gqa_reduce, attention_delta, flash_bwd_cuda,
        flash_fwd_cuda,
    )

    kb, vb = _gqa_broadcast(q, k, v)
    per = q.shape[1] // n
    outs, lses, dqs, dks, dvs = [], [], [], [], []
    for r in range(n):
        sl = slice(r * per, (r + 1) * per)
        out, lse = flash_fwd_cuda(q[:, sl], kb[:, sl], vb[:, sl], True,
                                  scale)
        dq, dk, dv = flash_bwd_cuda(q[:, sl], kb[:, sl], vb[:, sl],
                                    g[:, sl], lse,
                                    attention_delta(g[:, sl], out), True,
                                    scale)
        for acc, x in zip((outs, lses, dqs, dks, dvs),
                          (out, lse, dq, dk, dv)):
            acc.append(x)
    dk, dv = _gqa_reduce(torch.cat(dks, 1).float(),
                         torch.cat(dvs, 1).float(), k.shape[1])
    return (torch.cat(outs, 1), torch.cat(lses, 1), torch.cat(dqs, 1),
            dk.to(k.dtype), dv.to(v.dtype))


def _sp_hold(tag: str, got, want, plain, phase: str = "parallel") -> None:
    """out, dq, dk, dv by norm (NORM_TOL, whole tensor and worst row) and
    lse elementwise (LSE_TOL), against K1-K3 on the whole sequence and
    against the plain versions."""
    for ref_name, ref in (("K1-K3 whole", want), ("plain", plain)):
        parts = []
        for name, a, b in zip(("out", "lse", "dq", "dk", "dv"), got, ref):
            if name == "lse":
                err, ok = max_err(a, b, LSE_TOL)
                parts.append(f"lse {err:.2e}")
            else:
                total, row, where = norm_err(a, b)
                ok = total <= NORM_TOL and row <= NORM_TOL
                parts.append(f"{name} {total:.2e}/{row:.2e}")
            check(ok, f"{tag} {name} against {ref_name}: "
                      f"{parts[-1]} {'' if name == 'lse' else where}")
        log(f"{phase}: {tag} vs {ref_name} (norm / worst row): "
            + ", ".join(parts))


def _parallel_sp(shape: tuple = SP_SHAPE, phase: str = "parallel"
                 ) -> dict[str, int]:
    """(b): the ring and Ulysses for SP_RANKS virtual ranks at `shape`
    (B, H, Hkv, S, D), exact launches, held against K1-K3 on the whole
    sequence and the plain versions, timed beside them; `phase` heads
    the log lines. Returns their launches."""
    import torch

    from tony_tpu_torch.ops import cuda_lib
    from tony_tpu_torch.ops.attention import (
        attention_delta, blockwise_backward, blockwise_forward,
        flash_bwd_cuda, flash_fwd_cuda,
    )

    b, h, hk, s, d = shape
    gen = torch.Generator(device="cuda").manual_seed(7)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16)

    q, k, v, g = rand(b, h, s, d), rand(b, hk, s, d), rand(b, hk, s, d), \
        rand(b, h, s, d)
    scale = d ** -0.5

    def whole_fwd():
        return flash_fwd_cuda(q, k, v, True, scale)

    out, lse = whole_fwd()
    delta = attention_delta(g, out)

    def whole_bwd():
        return flash_bwd_cuda(q, k, v, g, lse, delta, True, scale)

    want = (out, lse) + whole_bwd()
    # the plain versions as the kernels phase holds K1-K3 to them: the
    # forward on its own, the backward on K1's (out, lse)
    plain = blockwise_forward(q, k, v, True, scale) + blockwise_backward(
        q, k, v, out, lse, g, True, scale)
    n = SP_RANKS
    pairs = n * (n + 1) // 2
    launches = {}
    for tag, fn, want_n in (("ring", _sp_ring, pairs),
                            ("ulysses", _sp_ulysses, n)):
        cuda_lib.reset_launches()
        got = fn(q, k, v, g, scale, n)
        torch.cuda.synchronize()
        counts = {name: cuda_lib.launches()[name] for name in
                  ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
        log(f"{phase}: {tag} sp={n} at B{b} H{h}/{hk} S{s} D{d} bf16 "
            f"causal: launches {counts}" + (
                f" ({n * n - pairs} future pairs launch nothing)"
                if tag == "ring" else ""))
        check(counts == dict.fromkeys(counts, want_n),
              f"{tag} launches {counts}, want {want_n} each")
        _sp_hold(f"{tag} sp={n}", got, want, plain, phase)
        launches[tag] = counts
        del got
    # device time of the whole path (forward and backward, all n ranks'
    # chunks one after another) beside K1 + K2/K3 on the whole sequence
    whole_ms = timed(lambda: (whole_fwd(), whole_bwd()), 3)[0]
    for tag, fn in (("ring", _sp_ring), ("ulysses", _sp_ulysses)):
        ms = timed(lambda: fn(q, k, v, g, scale, n), 3)[0]
        log(f"{phase}: {tag} sp={n} forward + backward, every rank's "
            f"chunks: {ms:.4f} ms on the device; K1 + K2/K3 on the whole "
            f"sequence {whole_ms:.4f} ms ({ms / whole_ms:.2f}x)")
    cuda_lib.reset_launches()
    return {name: sum(c[name] for c in launches.values())
            for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}


def phase_parallel(smi: str) -> tuple[dict[str, int], dict[str, int]]:
    """(a) the NCCL world of one through the mesh machinery against the
    plain run, bit for bit; (b) the ring's and Ulysses' arithmetic for
    sp = 4 at full width. Returns (a)'s and (b)'s launches."""
    import torch
    log(f"parallel: card {smi}")
    root = tempfile.mkdtemp(prefix="tony-parallel-")
    try:
        mesh_launches = _parallel_world_of_one(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    sp_launches = _parallel_sp()
    gc.collect()
    torch.cuda.empty_cache()
    return mesh_launches, sp_launches


# ---------------------------------------------------------------------------
# phase 11: pipeline and expert parallelism on one card
# ---------------------------------------------------------------------------

# (a) the train phase's model, weights and batch through the schedule of
# PIPE_STAGES stages in this process (`LocalStages`: a copy stands in for
# each send), each (n_micro, n_virtual) of PIPE_RUNS PIPE_TIMED times
PIPE_STAGES = 4
PIPE_RUNS = ((4, 1), (4, 2))
PIPE_TIMED = 3
# the pipelined loss against the plain step's on the same batch and
# weights, relative (the same math in another grouping of rows: bf16
# products of other shapes, the weight gradients summed over microbatches
# in f32); each gradient by norm
PIPE_LOSS_RTOL = 1e-3
PIPE_GRAD_TOL = 1e-2
# (b) `--pp-micro` through the entry point on an NCCL world of one, its
# PIPE_STEPS losses beside the plain run's (PIPE_LOSS_RTOL each)
PIPE_STEPS = 3
PIPE_MESH = {"TPU_MESH_SHAPE": "1,1", "TPU_MESH_AXES": "pp,fsdp"}
# (c) mixtral_proxy at full width, EP_LAYERS of its 16 layers, through the
# entry point on an NCCL world of one with an (ep, fsdp) mesh: bit for bit
# the plain run
EP_MESH = {"TPU_MESH_SHAPE": "1,1", "TPU_MESH_AXES": "ep,fsdp"}
EP_LAYERS = 4


def _pipeline_launches(n_layers: int, n_micro: int) -> dict[str, int]:
    """The kernel launches of one pipelined save_flash step: per layer and
    microbatch, K1 in the forward tick and again in the backward tick's
    recompute (the recompute's replay keeps its out and lse), K2 and K3
    once, RMSNorm twice in each of the forward tick, the recompute and
    its replay; and the final norm once."""
    lm = n_layers * n_micro
    return {"flash_fwd": 2 * lm, "flash_bwd_dq": lm, "flash_bwd_dkv": lm,
            "rmsnorm_fwd": 6 * lm + 1, "int8_matmul": 0,
            "decode_attention": 0}


def _grad_norm_err(got, want) -> float:
    """||got - want|| / ||want||, in f32."""
    import torch
    want = want.float()
    return float(torch.linalg.vector_norm(got.float() - want)
                 / torch.linalg.vector_norm(want).clamp_min(1e-30))


def _pipeline_one_process(peaks) -> dict[str, int]:
    """(a): the plain step's loss and gradients (forward and backward, no
    update) against `llama_loss_pipelined` on `LocalStages(PIPE_STAGES)`
    for each of PIPE_RUNS, exact launches on every pipelined run, both
    timed; then K1-K4 against their plain versions at the microbatch's
    shapes. Returns the pipelined runs' launches."""
    import torch

    from tony_tpu_torch.models.llama import (
        get_config, llama_init, llama_loss, llama_loss_pipelined,
    )
    from tony_tpu_torch.ops import cuda_lib
    from tony_tpu_torch.parallel.pipeline import LocalStages
    from tony_tpu_torch.train.checkpoint import flatten_with_paths
    from tony_tpu_torch.train.data import synthetic_tokens

    cfg = get_config(TRAIN_CONFIG)
    params = llama_init(cfg, torch.Generator(device="cuda").manual_seed(0))
    leaves = flatten_with_paths(params)
    for _, leaf in leaves:
        leaf.requires_grad_(True)
    tokens = next(synthetic_tokens(TRAIN_BATCH, TRAIN_SEQ,
                                   cfg.vocab_size))["tokens"]
    batch = {"tokens": torch.from_numpy(tokens).to("cuda")}

    def step(loss_fn) -> tuple[float, float]:
        for _, leaf in leaves:
            leaf.grad = None
        torch.cuda.synchronize()
        t0 = time.monotonic()
        loss = loss_fn(params, batch)
        loss.backward()
        torch.cuda.synchronize()
        return loss.item(), time.monotonic() - t0

    runs = [step(lambda p, b: llama_loss(p, b, cfg))
            for _ in range(PIPE_TIMED)]
    plain_loss = runs[-1][0]
    plain_s = sorted(w for _, w in runs)[len(runs) // 2]
    plain_grads = {path: leaf.grad.clone() for path, leaf in leaves}
    total = dict.fromkeys(_pipeline_launches(cfg.n_layers, 1), 0)
    for n_micro, v in PIPE_RUNS:
        want = _pipeline_launches(cfg.n_layers, n_micro)
        tag = f"pp={PIPE_STAGES} M={n_micro} v={v}"
        walls, losses = [], []
        for _ in range(PIPE_TIMED):
            cuda_lib.reset_launches()
            loss, wall = step(lambda p, b: llama_loss_pipelined(
                p, b, cfg, LocalStages(PIPE_STAGES), n_micro,
                n_virtual=v))
            got = {name: cuda_lib.launches()[name] for name in want}
            check(got == want, f"pipeline {tag} launches {got} != {want}")
            for name in want:
                total[name] += got[name]
            walls.append(wall)
            losses.append(loss)
        rel = abs(losses[-1] - plain_loss) / abs(plain_loss)
        errs = {path: _grad_norm_err(leaf.grad, plain_grads[path])
                for path, leaf in leaves}
        worst = max(errs, key=errs.get)
        wall = sorted(walls)[len(walls) // 2]
        log(f"pipeline: {TRAIN_CONFIG} B{TRAIN_BATCH} x S{TRAIN_SEQ} "
            f"{tag}, one process: loss {losses[-1]:.9g} against the plain "
            f"step's {plain_loss:.9g} (relative {rel:.2e}, tol "
            f"{PIPE_LOSS_RTOL}); worst gradient by norm {errs[worst]:.2e} "
            f"({'/'.join(worst)}, tol {PIPE_GRAD_TOL}); launches "
            f"{want} each run; forward + backward {wall:.4f} s against "
            f"the plain {plain_s:.4f} s ({wall / plain_s:.2f}x; walls "
            f"{[round(w, 4) for w in walls]})")
        check(rel <= PIPE_LOSS_RTOL, f"pipeline {tag} loss {losses[-1]} "
              f"against {plain_loss}")
        check(errs[worst] <= PIPE_GRAD_TOL,
              f"pipeline {tag} gradient {'/'.join(worst)} {errs[worst]}")
    del plain_grads, params, leaves
    gc.collect()
    torch.cuda.empty_cache()
    # the kernels at the microbatch's shapes, held as the kernels phase
    # holds them (K1 also run twice, bit for bit)
    mb = TRAIN_BATCH // PIPE_RUNS[0][0]
    dq, dkv, fwd = _flash_bwd_case(mb, cfg.n_heads, cfg.n_kv_heads,
                                   TRAIN_SEQ, cfg.head_dim, True,
                                   "bfloat16", "bshd", peaks,
                                   timed_case=True)
    flush = torch.empty(2 * torch.cuda.get_device_properties(0).L2_cache_size
                        // 4, device="cuda")
    rms = _rms_case(mb * TRAIN_SEQ, cfg.dim, torch.bfloat16, peaks, 50,
                    flush)
    del flush
    for name, r in (("flash_fwd", fwd), ("flash_bwd_dq", dq),
                    ("flash_bwd_dkv", dkv), ("rmsnorm_fwd", rms)):
        log(f"pipeline: the microbatch's shape (B{mb}):")
        _report(name, r)
        _hold_all(name, [r])
    torch.cuda.empty_cache()
    return total


def _pipeline_entry() -> dict[str, int]:
    """(b): `--pp-micro` through the entry point on an NCCL world of one
    (a pp of 1, so the pipelined loss with no send) beside the plain run.
    Returns its launches."""
    flags = ["--config", TRAIN_CONFIG, "--steps", str(PIPE_STEPS),
             "--batch-size", str(TRAIN_BATCH), "--seq-len", str(TRAIN_SEQ),
             "--log-every", "1"]
    n_micro = PIPE_RUNS[0][0]
    plain_losses, plain_step, _ = _plain_run(flags)
    run = _mesh_run(flags + ["--pp-micro", str(n_micro)], PIPE_MESH, (
        "mesh: {'fsdp': 1, 'pp': 1}", "params: 12 DTensor leaves"))
    rel = [abs(a - b) / abs(b) for a, b in zip(run["losses"],
                                               plain_losses)]
    log(f"pipeline: `python -m tony_tpu_torch.train --pp-micro {n_micro}` "
        f"on an NCCL world of one, mesh {PIPE_MESH}: losses "
        f"{[f'{x:.9g}' for x in run['losses']]}, plain "
        f"{[f'{x:.9g}' for x in plain_losses]} (relative "
        f"{[f'{x:.2e}' for x in rel]}, tol {PIPE_LOSS_RTOL}); median step "
        f"{run['step']:.4f} s, plain {plain_step:.4f} s; subprocess wall "
        f"{run['wall']:.1f} s")
    check(len(rel) == PIPE_STEPS and max(rel) <= PIPE_LOSS_RTOL,
          f"entry point pipelined losses {run['losses']} against "
          f"{plain_losses}")
    want = {name: PIPE_STEPS * n for name, n in
            _pipeline_launches(16, n_micro).items()}
    got = {name: run["launches"].get(name, 0) for name in want}
    check(got == want, f"pipelined entry point launches {got} != {want}")
    return got


def _ep_world_of_one(root: str) -> dict[str, int]:
    """(c): mixtral_proxy through the entry point on an NCCL world of one
    with an (ep, fsdp) mesh (`moe_param_axes`, the sharded MLP) against
    the plain run, bit for bit. Returns the mesh run's launches."""
    flags = ["--config", MOE_CONFIG, "--n-layers", str(EP_LAYERS),
             "--steps", str(PIPE_STEPS), "--batch-size",
             str(MOE_TRAIN_BATCH), "--seq-len", str(TRAIN_SEQ),
             "--log-every", "1"]
    plain_losses, plain_step, plain = _plain_run(flags)
    ckpt_dir = os.path.join(root, "ep")
    run = _mesh_run(flags, EP_MESH, ("mesh: {'fsdp': 1, 'ep': 1}",
                                     "params: 13 DTensor leaves"), ckpt_dir)
    log(f"pipeline: {MOE_CONFIG} ({EP_LAYERS} layers) B{MOE_TRAIN_BATCH} x "
        f"S{TRAIN_SEQ} on an NCCL world of one, mesh {EP_MESH}: losses "
        f"{[f'{x:.9g}' for x in run['losses']]}, plain "
        f"{[f'{x:.9g}' for x in plain_losses]}; median step "
        f"{run['step']:.4f} s, plain {plain_step:.4f} s; subprocess wall "
        f"{run['wall']:.1f} s")
    check([f"{x:.9g}" for x in plain_losses]
          == [f"{x:.9g}" for x in run["losses"]],
          "the ep mesh run's losses are not the plain run's bit for bit")
    _bitwise_params(os.path.join(ckpt_dir, f"step_{PIPE_STEPS}"), plain)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    want = {name: PIPE_STEPS * n for name, n in
            _step_launches(EP_LAYERS).items()}
    got = {name: run["launches"].get(name, 0) for name in want}
    check(got == want, f"ep mesh run launches {got} != {want}")
    return got


def phase_pipeline(smi: str, peaks) -> dict[str, dict[str, int]]:
    """(a) the pipeline schedule in one process at full width; (b) the
    entry point's pipelined loss on an NCCL world of one; (c) MoE on an
    (ep, fsdp) mesh of one through the entry point. Returns each part's
    launches, by path."""
    import torch
    log(f"pipeline: card {smi}")
    t0 = time.monotonic()
    launches = {"pipeline": _pipeline_one_process(peaks),
                "pipeline_entry": _pipeline_entry()}
    root = tempfile.mkdtemp(prefix="tony-ep-")
    try:
        launches["ep"] = _ep_world_of_one(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"pipeline: phase done in {time.monotonic() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 12: speculative decoding through the generate demo
# ---------------------------------------------------------------------------

# `python -m tony_tpu_torch.examples.generate_demo` in this process at full
# width: the target, the draft (both vocab 32000), gamma, batch, prompt and
# new tokens; an MoE target at no-drop capacity with fewer new tokens
SPEC_TARGET, SPEC_DRAFT, SPEC_MOE_TARGET = (
    "llama3_1b_proxy", "bench_350m", MOE_CONFIG)
SPEC_GAMMA, SPEC_BATCH, SPEC_PROMPT, SPEC_NEW, SPEC_MOE_NEW = 4, 4, 128, \
    64, 32


def _spec_launches(cfg, dcfg, rounds: int, batch: int, prompt: int,
                   gamma: int, int8_target: bool) -> dict[str, int]:
    """The kernel launches of one `speculative_generate`: K1 in each
    prefill's layers; K4 twice a layer and once for the final norm in each
    prefill and each window (gamma + 1 draft windows and one target window
    a round); K5 (int8 target) in each product of at most KERNEL_MAX_ROWS
    rows: the prefill's LM head on its last rows, the windows' where
    batch * (gamma + 1) is small enough. K6 never: the windows attend
    through `_window_attention`, not `decode_step`."""
    from tony_tpu_torch.ops.int8_matmul import KERNEL_MAX_ROWS

    def k4(c):
        return 2 * c.n_layers + 1

    def k5(rows: int, head_rows: int) -> int:
        if not int8_target:
            return 0
        return (cfg.n_layers * 7 * (rows <= KERNEL_MAX_ROWS)
                + (head_rows <= KERNEL_MAX_ROWS))

    window = batch * (gamma + 1)
    return {"flash_fwd": cfg.n_layers + dcfg.n_layers,
            "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "rmsnorm_fwd": k4(cfg) + k4(dcfg)
            + rounds * ((gamma + 1) * k4(dcfg) + k4(cfg)),
            "int8_matmul": k5(batch * prompt, batch)
            + rounds * k5(window, window), "decode_attention": 0}


def _target_windows(rerun, gamma: int) -> tuple:
    """`rerun()` (a `speculative_generate` call) once more with every
    target window's (lens, tokens, logits) kept: the windows of gamma + 1
    tokens (a draft step's window has one). Returns (its stream, the
    windows in round order)."""
    from tony_tpu_torch.models import speculative

    windows: list = []
    plain = speculative.window_logits

    def kept(params, config, cache, tokens, lens):
        logits, cache = plain(params, config, cache, tokens, lens)
        if tokens.shape[1] == gamma + 1:
            windows.append((lens.clone(), tokens.clone(), logits.clone()))
        return logits, cache

    speculative.window_logits = kept
    try:
        stream = rerun()
    finally:
        speculative.window_logits = plain
    return stream, windows


def _decode_logits(params, cfg, prompt, stream, upto: int,
                   quant_cache: bool) -> list:
    """`generate`'s own path on the prompt and `stream` (prefill, then a
    decode step per token): element j is the logits (B, V) that pick
    token j, for j <= upto."""
    import torch

    from tony_tpu_torch.models.generate import decode_step, prefill

    p, n = prompt.shape[1], stream.shape[1]
    with torch.inference_mode():
        logits, cache = prefill(params, prompt, cfg, p + n,
                                quant_cache=quant_cache)
        decoded = [logits]
        for t in range(upto):
            logits, cache = decode_step(params, cfg, cache, stream[:, t],
                                        p + t)
            decoded.append(logits)
    return decoded


def _hold_stream(label: str, got, want, rerun, params, cfg, prompt,
                 gamma: int, quant_cache: bool, exact: bool) -> int:
    """The speculative stream `got` against greedy `generate`'s `want`:
    token for token when `exact` (f32). Else a row may part from it at
    token j only where the target window that emitted j (kept from a
    rerun of `rerun()`, which must give the same stream) saw greedy's
    prefix, emitted its own argmax b there, and flipped the pair against
    the decode step's: with a = greedy's token (the decode step's argmax)
    and m = dec[a] - dec[b] its margin, m < |(win[a] - win[b]) - m|. The
    largest |win - dec| over the vocabulary is printed beside it. Returns
    the rows that parted."""
    parts = {}
    for row in range(got.shape[0]):
        diff = (got[row] != want[row]).nonzero()
        if len(diff):
            parts[row] = int(diff[0])
    for row, j in parts.items():
        check(not exact and j > 0, f"spec {label}: row {row} parts from "
              f"greedy generate at token {j}")
    if not parts:
        return 0
    again, windows = _target_windows(rerun, gamma)
    check(bool((again == got).all()), f"spec {label}: a rerun's stream is "
          "not the first run's")
    decoded = _decode_logits(params, cfg, prompt, want, max(parts.values()),
                             quant_cache)
    p = prompt.shape[1]
    for row, j in parts.items():
        a, b = int(want[row, j]), int(got[row, j])
        at = p + j - 1                  # the position whose row picks j
        lens, tokens, logits = [w for w in windows
                                if int(w[0][row]) <= at][-1]
        i = at - int(lens[row])
        check(0 <= i <= gamma, f"spec {label}: row {row} token {j} lies "
              f"outside its window (row {i})")
        seen = tokens[row, :i + 1]
        check(bool((seen == want[row, j - 1 - i:j]).all()),
              f"spec {label}: row {row}'s window for token {j} saw "
              f"{seen.tolist()}, not greedy's prefix")
        win, dec = logits[row, i].float(), decoded[j][row].float()
        check(int(win.argmax()) == b, f"spec {label}: row {row} emitted "
              f"{b} at token {j}, not its window's argmax "
              f"{int(win.argmax())}")
        check(int(dec.argmax()) == a, f"spec {label}: row {row}'s decode "
              f"step picks {int(dec.argmax())} at token {j}, not greedy's "
              f"{a}")
        margin = float(dec[a] - dec[b])
        flip = abs(float(win[a] - win[b]) - margin)
        log(f"spec {label}: row {row} parts from greedy generate at token "
            f"{j} ({a} -> {b}): decode-step margin dec[a] - dec[b] "
            f"{margin:.4e}, the window's shift of that pair {flip:.4e}; "
            f"largest |window - decode-step| logit over the vocabulary "
            f"{float((win - dec).abs().max()):.4e}")
        check(margin < flip, f"spec {label}: row {row} parts at token {j} "
              f"with a margin {margin} not below the window's shift {flip}")
    return len(parts)


def _spec_run(label: str, flags: list[str], new: int, exact: bool,
              quant_cache: bool) -> dict[str, int]:
    """One demo run (`generate_demo.run`) with `flags`, its launches exact
    for its round count, its stream held against greedy `generate` on the
    same weights; then both timed warm. Returns the demo's launches."""
    import io

    import torch

    from tony_tpu_torch.examples import generate_demo
    from tony_tpu_torch.models.generate import generate
    from tony_tpu_torch.models.speculative import speculative_generate
    from tony_tpu_torch.ops import cuda_lib

    argv = ["--batch-size", str(SPEC_BATCH), "--prompt-len",
            str(SPEC_PROMPT), "--max-new", str(new), "--gamma",
            str(SPEC_GAMMA), *flags]
    out = io.StringIO()
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    with contextlib.redirect_stdout(out):
        r = generate_demo.run(argv)
    torch.cuda.synchronize()
    got_launches = cuda_lib.launches()
    check("GENERATE_OK" in out.getvalue(), f"spec {label}: no GENERATE_OK")
    cfg, dcfg, stats = r["config"], r["draft_config"], r["stats"]
    rounds = stats["rounds"]
    want = _spec_launches(cfg, dcfg, rounds, SPEC_BATCH, SPEC_PROMPT,
                          SPEC_GAMMA, "--quant" in flags)
    check(got_launches == want, f"spec {label}: launches {got_launches} "
          f"!= {want} for {rounds} rounds")
    params, prompt = r["params"], r["prompt"]
    greedy = generate(params, cfg, prompt, new, quant_cache=quant_cache)
    parted = _hold_stream(
        label, r["tokens"], greedy, lambda: speculative_generate(
            params, r["draft_params"], cfg, dcfg, prompt, new,
            gamma=SPEC_GAMMA, quant_cache=quant_cache),
        params, cfg, prompt, SPEC_GAMMA, quant_cache, exact)

    def timed_call(fn):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        return time.monotonic() - t0

    again: dict = {}
    spec_s = timed_call(lambda: speculative_generate(
        params, r["draft_params"], cfg, dcfg, prompt, new, gamma=SPEC_GAMMA,
        quant_cache=quant_cache, stats=again))
    greedy_s = timed_call(lambda: generate(params, cfg, prompt, new,
                                           quant_cache=quant_cache))
    tokens = SPEC_BATCH * new
    log(f"spec {label}: {rounds} rounds, {stats['accepted']} drafted "
        f"tokens accepted ({stats['accepted'] / rounds / SPEC_BATCH:.3f} a "
        f"row a round, gamma {SPEC_GAMMA}); rows parted from greedy "
        f"{parted}/{SPEC_BATCH}; launches {got_launches}; warm: "
        f"{spec_s:.4f} s ({1e3 * spec_s / again['rounds']:.2f} ms a round, "
        f"{tokens / spec_s:.1f} tokens/s) against greedy generate's "
        f"{greedy_s:.4f} s ({tokens / greedy_s:.1f} tokens/s)")
    del r, params, greedy
    gc.collect()
    torch.cuda.empty_cache()
    return got_launches


def _spec_self_draft() -> dict[str, int]:
    """The target as its own draft (the demo's weights and prompt): every
    drafted token a window agrees with is accepted, so few rounds; the
    stream held against greedy `generate`. Returns its launches."""
    import io

    import torch

    from tony_tpu_torch.examples import generate_demo
    from tony_tpu_torch.models.generate import generate
    from tony_tpu_torch.models.speculative import speculative_generate
    from tony_tpu_torch.ops import cuda_lib

    with contextlib.redirect_stdout(io.StringIO()):
        r = generate_demo.run(["--config", SPEC_TARGET, "--batch-size",
                               str(SPEC_BATCH), "--prompt-len",
                               str(SPEC_PROMPT), "--max-new", "1"])
    params, cfg, prompt = r["params"], r["config"], r["prompt"]
    stats: dict = {}
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    t0 = time.monotonic()
    got = speculative_generate(params, params, cfg, cfg, prompt, SPEC_NEW,
                               gamma=SPEC_GAMMA, stats=stats)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = cuda_lib.launches()
    want = _spec_launches(cfg, cfg, stats["rounds"], SPEC_BATCH,
                          SPEC_PROMPT, SPEC_GAMMA, False)
    check(launches == want, f"spec self-draft: launches {launches} != "
          f"{want}")
    greedy = generate(params, cfg, prompt, SPEC_NEW)
    parted = _hold_stream(
        "self-draft", got, greedy, lambda: speculative_generate(
            params, params, cfg, cfg, prompt, SPEC_NEW, gamma=SPEC_GAMMA),
        params, cfg, prompt, SPEC_GAMMA, False, exact=False)
    least = -(-(SPEC_NEW - 1) // (SPEC_GAMMA + 1))
    log(f"spec self-draft ({SPEC_TARGET} as its own draft): "
        f"{stats['rounds']} rounds (the least possible {least}), "
        f"{stats['accepted']} drafted tokens accepted "
        f"({stats['accepted'] / stats['rounds'] / SPEC_BATCH:.3f} a row a "
        f"round); rows parted {parted}/{SPEC_BATCH}; {wall:.4f} s "
        f"({1e3 * wall / stats['rounds']:.2f} ms a round, "
        f"{SPEC_BATCH * SPEC_NEW / wall:.1f} tokens/s)")
    check(stats["rounds"] <= 2 * least, f"spec self-draft took "
          f"{stats['rounds']} rounds for a least of {least}")
    del r, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _spec_tiny_f32() -> None:
    """tiny in f32 on the card (a one-layer draft): every stream token for
    token greedy `generate`'s, for gamma 1, 3 and 4 and the int8 cache."""
    import torch

    from tony_tpu_torch.models.generate import generate
    from tony_tpu_torch.models.llama import get_config, llama_init
    from tony_tpu_torch.models.speculative import speculative_generate

    cfg, dcfg = get_config("tiny"), get_config("tiny", n_layers=1)
    g = torch.Generator(device="cuda")
    params = llama_init(cfg, g.manual_seed(0))
    draft = llama_init(dcfg, g.manual_seed(7))
    prompt = torch.randint(0, cfg.vocab_size, (3, 8), generator=g,
                           device="cuda")
    for gamma, quant_cache in ((1, False), (3, False), (4, False),
                               (3, True)):
        got = speculative_generate(params, draft, cfg, dcfg, prompt, 24,
                                   gamma=gamma, quant_cache=quant_cache)
        want = generate(params, cfg, prompt, 24, quant_cache=quant_cache)
        _hold_stream(f"tiny f32 gamma {gamma}"
                     f"{' int8 cache' if quant_cache else ''}", got, want,
                     None, params, cfg, prompt, gamma, quant_cache,
                     exact=True)
    log("spec: tiny f32 streams (gamma 1, 3, 4; the int8 cache) token for "
        "token greedy generate's on the card")


def phase_spec() -> dict[str, int]:
    """Speculative decoding through the generate demo at full width (a
    random draft, the target as its own draft, int8 weights and cache, an
    MoE target), each stream held against greedy `generate` and each
    run's launches exact for its rounds; tiny in f32 token for token.
    Returns the launches of the four full-width runs together."""
    t0 = time.monotonic()
    demo = ["--config", SPEC_TARGET, "--draft-config", SPEC_DRAFT]
    runs = [
        _spec_run(f"{SPEC_TARGET} + {SPEC_DRAFT} draft", demo, SPEC_NEW,
                  exact=False, quant_cache=False),
        _spec_self_draft(),
        _spec_run(f"{SPEC_TARGET} int8 + int8 cache",
                  demo + ["--quant", "int8", "--quant-cache"], SPEC_NEW,
                  exact=False, quant_cache=True),
        _spec_run(f"{SPEC_MOE_TARGET} (no-drop) + {SPEC_DRAFT} draft",
                  ["--config", SPEC_MOE_TARGET, "--draft-config",
                   SPEC_DRAFT], SPEC_MOE_NEW, exact=False,
                  quant_cache=False)]
    _spec_tiny_f32()
    total = {name: sum(r.get(name, 0) for r in runs) for name in runs[0]}
    log(f"spec: phase done in {time.monotonic() - t0:.1f} s; launches "
        f"{total}")
    return total


# ---------------------------------------------------------------------------
# phase 13: the image zoo and the small models through their entry points
# ---------------------------------------------------------------------------

# train_allreduce through its entry point on an NCCL world of one (one
# worker in CLUSTER_SPEC, a 1-rank fsdp mesh): (model, preset), each at the
# example's mnist geometry, per-process batch and ALLREDUCE_STEPS steps
ALLREDUCE_RUNS = (("vit", "vit_s16_proxy"), ("resnet", "resnet50_proxy"))
ALLREDUCE_STEPS, ALLREDUCE_BATCH = 10, 32
# the Trainer on vit_s16_proxy at its own 224/16 geometry
VIT_TRAIN_BATCH, VIT_TRAIN_STEPS = 64, 6
# the tiny f32 models' forward on the card against the CPU's
VISION_F32_TOL = 2e-5


def _vit_step_launches(n_layers: int) -> dict[str, int]:
    """One ViT training step (no remat): per layer K1 once, K2 and K3 once
    and K4 twice; the CLS rows' final norm once."""
    return {"flash_fwd": n_layers, "flash_bwd_dq": n_layers,
            "flash_bwd_dkv": n_layers, "rmsnorm_fwd": 2 * n_layers + 1,
            "int8_matmul": 0, "decode_attention": 0}


def _allreduce_entry(model: str, preset: str) -> dict[str, int]:
    """`python -m tony_tpu_torch.examples.train_allreduce` on an NCCL world
    of one: its rendezvous from CLUSTER_SPEC, the nccl group and mesh
    logged, no gloo, a finite final loss, its own count of its launches
    exact. Returns that count."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent),
               CLUSTER_SPEC=json.dumps({"worker": [f"127.0.0.1:{port}"]}),
               TASK_INDEX="0", TPU_MESH_SHAPE="1", TPU_MESH_AXES="fsdp")
    t0 = time.monotonic()
    out = subprocess.run(
        [sys.executable, "-m", "tony_tpu_torch.examples.train_allreduce",
         "--model", model, "--config", preset, "--steps",
         str(ALLREDUCE_STEPS), "--batch-size", str(ALLREDUCE_BATCH)],
        capture_output=True, text=True, env=env, timeout=600)
    wall = time.monotonic() - t0
    err = out.stderr
    check(out.returncode == 0, f"train_allreduce {model} exit "
          f"{out.returncode}: {err[-3000:]}")
    for needle in ("allreduce rendezvous: 127.0.0.1", "init_process_group("
                   "nccl", "mesh: {'fsdp': 1}"):
        check(needle in err, f"train_allreduce {model} never logged "
                             f"{needle!r}")
    check("gloo" not in err, "a gloo group on the card")
    final = out.stdout.strip().splitlines()[-1]
    check(final.startswith("final loss ") and math.isfinite(
        float(final.split()[2])), f"train_allreduce {model}: {final!r}")
    launches = json.loads(re.search(r"kernel launches (\{.*\})",
                                    err).group(1))
    if model == "vit":
        from tony_tpu_torch.models.vit import get_config
        want = {k: ALLREDUCE_STEPS * v for k, v in _vit_step_launches(
            get_config(preset).n_layers).items()}
    else:
        want = dict.fromkeys(_vit_step_launches(1), 0)
    check(launches == want, f"train_allreduce {model} launches {launches} "
          f"!= {want}")
    losses = re.findall(r"step (\d+) loss (\S+)", err)
    log(f"vision: train_allreduce --model {model} --config {preset} "
        f"(28 x 28 x 1, batch {ALLREDUCE_BATCH}) on an NCCL world of one: "
        f"{final}; losses {losses}; launches {launches}; subprocess wall "
        f"{wall:.1f} s")
    return launches


def _vit_trainer() -> dict[str, int]:
    """The Trainer on vit_s16_proxy at 224/16 (S 197), B 64, on numpy-seeded
    images: exact launches every step, finite losses, the step time,
    images/s and peak memory. Returns its launches."""
    from functools import partial

    import numpy as np
    import torch

    from tony_tpu_torch.models.vit import get_config, vit_init, vit_loss
    from tony_tpu_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_config("vit_s16_proxy")
    rng = np.random.default_rng(0)
    side = cfg.image_size
    batches = [{"images": rng.standard_normal(
                    (VIT_TRAIN_BATCH, side, side, cfg.in_channels),
                    dtype=np.float32),
                "labels": rng.integers(0, cfg.num_classes, VIT_TRAIN_BATCH,
                                       dtype=np.int32)} for _ in range(2)]
    trainer = Trainer(
        partial(vit_loss, config=cfg), partial(vit_init, cfg),
        (batches[i % 2] for i in range(VIT_TRAIN_STEPS)),
        TrainerConfig(num_steps=VIT_TRAIN_STEPS, log_every=1,
                      learning_rate=1e-3, warmup_steps=2), device="cuda")
    trainer.setup()
    want = _vit_step_launches(cfg.n_layers)
    steps: list = []
    trainer.train_step = _count_calls(trainer.train_step, want, steps)
    torch.cuda.reset_peak_memory_stats()
    trainer.run()
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [e["loss"] for e in trainer.metrics_history]
    check(len(steps) == VIT_TRAIN_STEPS and all(s == want for s in steps),
          f"vit_s16_proxy step launches {steps} != {want} each")
    check(all(math.isfinite(x) for x in losses), f"vit losses {losses}")
    step_s = _step_seconds([e["elapsed_s"] for e in trainer.metrics_history])
    log(f"vision: Trainer on vit_s16_proxy 224/16 (S {cfg.seq}), B "
        f"{VIT_TRAIN_BATCH}, {VIT_TRAIN_STEPS} steps: losses "
        f"{[f'{x:.6g}' for x in losses]}; step {step_s:.4f} s (median of "
        f"steps 3-{VIT_TRAIN_STEPS}), {VIT_TRAIN_BATCH / step_s:.1f} "
        f"images/s; peak {peak:.3f} GiB; launches {want} every step")
    total = {k: VIT_TRAIN_STEPS * v for k, v in want.items()}
    del trainer, batches
    gc.collect()
    torch.cuda.empty_cache()
    return total


def _small_entries() -> None:
    """mnist_distributed and linreg_dmlc through their entry points on the
    card, each with its own gate."""
    import io

    from tony_tpu_torch.examples import linreg_dmlc, mnist_distributed

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = mnist_distributed.main([])
    check(rc == 0, f"mnist_distributed exited {rc}: {out.getvalue()}")
    log(f"vision: mnist_distributed (200 steps, batch 128): "
        f"{out.getvalue().strip().splitlines()[-1]}")
    dmlc = {"DMLC_ROLE": "worker", "DMLC_PS_ROOT_URI": "127.0.0.1",
            "DMLC_PS_ROOT_PORT": str(_free_port()), "DMLC_NUM_SERVER": "1",
            "DMLC_NUM_WORKER": "1"}
    old = {k: os.environ.get(k) for k in dmlc}
    os.environ.update(dmlc)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = linreg_dmlc.main([])
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    check(rc == 0, f"linreg_dmlc exited {rc}: {out.getvalue()}")
    log(f"vision: linreg_dmlc: {out.getvalue().strip().splitlines()[-1]}")


def _tiny_f32_card_vs_cpu() -> None:
    """resnet_tiny and vit_tiny in f32: the card's logits (cuDNN in IEEE
    f32, K1 and K4 in f32) against the CPU's on the same weights and
    images."""
    import torch

    from tony_tpu_torch.models import resnet, vit
    from tony_tpu_torch.train.optim import tree_map

    g = torch.Generator().manual_seed(0)
    for name, cfg, init, forward in (
            ("resnet_tiny", resnet.get_resnet_config("resnet_tiny"),
             resnet.resnet_init, resnet.resnet_forward),
            ("vit_tiny", vit.get_config("vit_tiny"), vit.vit_init,
             vit.vit_forward)):
        params = init(cfg, g)
        if name == "vit_tiny":      # its zero head would give zero logits
            params["head_w"] = torch.randn(params["head_w"].shape,
                                           generator=g) * 0.1
        side = 28 if name == "resnet_tiny" else cfg.image_size
        chans = cfg.in_channels
        images = torch.randn((8, side, side, chans), generator=g)
        with torch.no_grad():
            want = forward(params, images, cfg)
            got = forward(tree_map(lambda t: t.cuda(), params),
                          images.cuda(), cfg)
        err, ok = max_err(got.cpu(), want, VISION_F32_TOL)
        log(f"vision: {name} f32 logits on the card against the CPU: max "
            f"abs err {err:.3e} (tol {VISION_F32_TOL})")
        check(ok, f"{name} f32 on the card differs from the CPU by {err}")


def phase_vision() -> dict[str, int]:
    """The image zoo and the small models through their entry points: ViT
    and ResNet through train_allreduce on an NCCL world of one, the
    Trainer on vit_s16_proxy at 224/16, mnist_distributed and linreg_dmlc
    with their gates, and the tiny f32 models' card forward against the
    CPU's. Returns the launches of the ViT training runs together."""
    t0 = time.monotonic()
    runs = [_allreduce_entry(model, preset)
            for model, preset in ALLREDUCE_RUNS]
    runs.append(_vit_trainer())
    _small_entries()
    _tiny_f32_card_vs_cpu()
    total = {name: sum(r.get(name, 0) for r in runs) for name in runs[0]}
    log(f"vision: phase done in {time.monotonic() - t0:.1f} s; launches "
        f"{total}")
    return total


# ---------------------------------------------------------------------------
# phase 14: the port's task executor, against the recording AM
# ---------------------------------------------------------------------------

# the metrics interval of the phase's frozen conf, its training run's steps,
# the wedge's sleep in intervals, and the most it may take
EXECUTOR_INTERVAL_MS = 500
EXECUTOR_TRAIN_STEPS = 6
EXECUTOR_WEDGE_INTERVALS = 6
EXECUTOR_TASK_S = 300.0
# the wedge: a context, 1 GiB, one kernel, then EXECUTOR_WEDGE_INTERVALS
# metrics intervals of sleep
WEDGE_COMMAND = (
    "import sys, time, torch\n"
    "x = torch.empty(1 << 30, dtype=torch.uint8, device='cuda')\n"
    "y = torch.randn(4096, 4096, device='cuda')\n"
    "float((y @ y).sum())\n"
    "print('WEDGED', flush=True)\n"
    "time.sleep(float(sys.argv[1]))\n")


def _executor_env(am: "_AmStandIn", root: str, conf_path: str, job: str,
                  command: str) -> dict[str, str]:
    """The env the AM's container launcher renders into an executor
    (`_container_env` of tony_tpu/am/application_master.py), over this
    process's own with every task variable of earlier phases removed."""
    repo = str(Path(__file__).resolve().parent)
    env = {k: v for k, v in os.environ.items()
           if k not in ("AM_HOST", "AM_PORT", "METRICS_RPC_PORT",
                        "JOB_NAME", "TASK_INDEX", "TONY_SECURITY_TOKEN",
                        "TONY_TRACE_ID", "TONY_PARENT_SPAN", "TB_PORT",
                        "IS_CHIEF", "RANK", "WORLD", "INIT_METHOD",
                        "TONY_JAX_CACHE_DIR")}
    env.update({
        "JOB_NAME": job, "TASK_INDEX": "0", "TASK_NUM": "1",
        "IS_CHIEF": "false", "SESSION_ID": "0", "AM_HOST": "127.0.0.1",
        "AM_PORT": str(am.port), "METRICS_RPC_PORT": str(am.port),
        "CONTAINER_ID": f"container_chip_smoke_{job}", "APP_ID":
        "chip_smoke", "ATTEMPT_NUMBER": "0", "TASK_ATTEMPT": "0",
        "NUM_AM_RETRIES": "0", "TONY_APP_DIR": root,
        "TONY_CONF_PATH": conf_path,
        "PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH", ""),
        "TONY_TRACE_ID": "chip-smoke-executor", "TONY_PARENT_SPAN":
        f"{job[:2].encode().hex()}" * 4, "TASK_COMMAND": command,
        "TONY_SECURITY_TOKEN": am.token})
    return env


class _CardWatch(threading.Thread):
    """Every 250 ms while a task runs: the pids NVML lists on the card,
    and whether the executor's own process holds a CUDA context by what
    /proc shows of it (it maps /dev/nvidia-uvm)."""

    def __init__(self, reader, executor_pid: int):
        super().__init__(daemon=True)
        self.reader, self.pid = reader, executor_pid
        self.nvml_pids: set[int] = set()
        self.executor_listed = self.executor_maps_uvm = False
        self.samples = 0
        self._halt = threading.Event()

    def run(self) -> None:
        from tony_tpu_torch.executor.cuda_metrics import holds_context
        while not self._halt.wait(0.25):
            for dev in self.reader.sample():
                self.nvml_pids.update(pid for pid, _ in dev.processes)
            self.executor_listed |= self.pid in self.nvml_pids
            self.executor_maps_uvm |= holds_context(self.pid)
            self.samples += 1

    def stop(self) -> None:
        self._halt.set()
        self.join(timeout=10)


def _run_executor(am: "_AmStandIn", root: str, conf_path: str, job: str,
                  command: str, reader, tag: str, during=None) -> dict:
    """`python -m tony_tpu_torch.executor` as the AM launches it, its
    stdout and stderr in files of its own cwd (as the local backend keeps
    them), watched by `_CardWatch`. `during(proc, cwd)` runs while it
    does (the serving task's checks and its SIGTERM); then the executor
    must exit within EXECUTOR_TASK_S. `tag` names the run."""
    cwd = os.path.join(root, tag)
    os.makedirs(cwd)
    am.set_gang({job: 1})
    am.clear()
    t_launch = time.time()
    with open(os.path.join(cwd, "stdout"), "w") as out, \
            open(os.path.join(cwd, "stderr"), "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "tony_tpu_torch.executor"], cwd=cwd,
            env=_executor_env(am, root, conf_path, job, command),
            stdout=out, stderr=err, start_new_session=True)
    watch = _CardWatch(reader, proc.pid)
    watch.start()
    try:
        if during is not None:
            during(proc, cwd)
        rc = proc.wait(timeout=EXECUTOR_TASK_S)
    except BaseException:
        with open(os.path.join(cwd, "stderr")) as f:
            log(f"executor: {tag}: the executor's stderr tail:\n"
                f"{f.read()[-3000:]}")
        raise
    finally:
        watch.stop()
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(timeout=30)
    with open(os.path.join(cwd, "stdout")) as f:
        stdout = f.read()
    with open(os.path.join(cwd, "stderr")) as f:
        stderr = f.read()
    return {"rc": rc, "t_launch": t_launch, "pid": proc.pid,
            "stdout": stdout, "stderr": stderr, "watch": watch,
            "heartbeats": [t for t, task, _ in
                           am.take_timed("task_executor_heartbeat")
                           if task == f"{job}:0"],
            "pushes": [(t, req) for t, task, req in
                       am.take_timed("update_metrics")
                       if task == f"{job}:0"],
            "results": [req for task, req in
                        am.take("register_execution_result")
                        if task == f"{job}:0"],
            "registrations": [req for task, req in
                              am.take("register_worker_spec")
                              if task == f"{job}:0"],
            "endpoints": [req for task, req in
                          am.take("register_serving_endpoint")
                          if task == f"{job}:0"]}


def _series(run: dict, name: str) -> list:
    """The values a metric took in the executor's pushes, push by push
    (None where a push lacks it: no card sample that interval). The
    executor's pushes are those with MAX_MEMORY_BYTES; a port trainer
    pushes its own gauges under the same task id."""
    out = []
    for _, req in run["pushes"]:
        values = {m["name"]: m["value"] for m in req.get("metrics", [])}
        if "MAX_MEMORY_BYTES" in values:
            out.append(values.get(name))
    return out


def _spans(run: dict) -> dict[str, dict]:
    return {s["name"]: s for _, req in run["pushes"]
            for s in req.get("spans") or []}


def _log_messages(stderr: str) -> list[str]:
    """The messages of a task's structured JSON log lines."""
    out = []
    for line in stderr.splitlines():
        if line.startswith("{"):
            try:
                out.append(json.loads(line).get("message", ""))
            except ValueError:
                continue
    return out


def _hb_gap_s(run: dict, t_end: float) -> float:
    """The longest silence between heartbeats from the first one to the
    last push of the run."""
    beats = run["heartbeats"]
    check(len(beats) >= 2, f"executor: {len(beats)} heartbeats arrived")
    gaps = [b - a for a, b in zip(beats, beats[1:])]
    return max(gaps + [max(0.0, t_end - beats[-1])])


def _timing_line(job: str, run: dict, smi: str) -> str:
    spans = _spans(run)
    wait = spans.get("rendezvous_wait")
    user = spans.get("user_process")
    parts = [f"barrier wait {wait['end_ms'] - wait['start_ms']} ms"
             if wait else "barrier wait: no span"]
    if user:
        parts.append(f"executor start -> user process start "
                     f"{user['start_ms'] - 1000 * run['t_launch']:.0f} ms")
    return f"executor: {job}: " + ", ".join(parts) + f"; {smi}"


def _executor_train(am, root, conf_path, reader, total_bytes: int,
                    smi: str) -> dict[str, int]:
    """(a) The trainer as a pytorch worker: exit 0 registered, heartbeats
    throughout, its own count of its launches exact, a duty sample >= 50,
    MAX_TPU_HBM_BYTES between its logged peak and the card's memory, and
    the executor never holding a context."""
    from tony_tpu_torch.models.llama import get_config

    steps = EXECUTOR_TRAIN_STEPS
    command = (f"{sys.executable} -m tony_tpu_torch.train --config "
               f"{TRAIN_CONFIG} --batch-size {TRAIN_BATCH} --seq-len "
               f"{TRAIN_SEQ} --steps {steps} --log-every 1")
    run = _run_executor(am, root, conf_path, "worker", command, reader,
                        "train")
    check(run["rc"] == 0 and [r["exit_code"] for r in run["results"]]
          == [0], f"executor: worker: exit {run['rc']}, results "
                  f"{run['results']}")
    regs = run["registrations"]
    check(regs and all(r["spec"].rpartition(":")[0] for r in regs),
          f"executor: worker: registrations {regs}")
    msgs = _log_messages(run["stderr"])
    launched = [json.loads(m[len("kernel launches "):]) for m in msgs
                if m.startswith("kernel launches ")]
    peaks = [float(m.split()[3]) for m in msgs
             if m.startswith("peak device memory ")]
    per_step = _step_launches(get_config(TRAIN_CONFIG).n_layers)
    want = {k: steps * v for k, v in per_step.items()}
    check(len(launched) == 1 and {k: launched[0].get(k) for k in want}
          == want, f"executor: the trainer logged launches {launched}, "
                   f"want {want} ({steps} x the train phase's step)")
    check(len(peaks) == 1, f"executor: the trainer's peak lines {peaks}")
    duty = _series(run, "TPU_UTILIZATION")
    hbm = _series(run, "MAX_TPU_HBM_BYTES")
    sampled = [d for d in duty if d is not None]
    check(sampled, "executor: the card yielded no duty sample for the "
                   "trainer")
    check(max(sampled) >= 50.0,
          f"executor: no push carried TPU_UTILIZATION >= 50: {duty}")
    max_hbm = max(h for h in hbm if h is not None)
    peak_bytes = peaks[0] * 2**30
    check(peak_bytes <= max_hbm <= total_bytes,
          f"executor: MAX_TPU_HBM_BYTES {max_hbm:.0f} not within "
          f"[{peak_bytes:.0f}, {total_bytes}]")
    watch = run["watch"]
    check(watch.samples > 0 and not watch.executor_listed
          and not watch.executor_maps_uvm,
          f"executor: the executor (pid {run['pid']}) held a context: "
          f"listed by NVML {watch.executor_listed}, maps the uvm device "
          f"{watch.executor_maps_uvm} ({watch.samples} watches)")
    gap = _hb_gap_s(run, run["pushes"][-1][0])
    check(gap <= 5 * EXECUTOR_INTERVAL_MS / 1000.0,
          f"executor: worker: heartbeats stopped for {gap:.2f} s")
    log(f"executor: train: {TRAIN_CONFIG} B{TRAIN_BATCH} x S{TRAIN_SEQ}, "
        f"{steps} steps as `{command.split(' ', 1)[1]}`: exit 0 "
        f"registered; {len(run['heartbeats'])} heartbeats, longest gap "
        f"{gap:.2f} s; the trainer's own count of its launches "
        f"{launched[0]} (= {steps} x the train phase's step); its peak "
        f"{peaks[0]:.3f} GiB <= MAX_TPU_HBM_BYTES {max_hbm / 2**30:.3f} GiB "
        f"<= the card's {total_bytes / 2**30:.1f} GiB; NVML listed pids "
        f"{sorted(watch.nvml_pids)}, never the executor's ({run['pid']}), "
        f"which never mapped /dev/nvidia-uvm ({watch.samples} watches)")
    log(f"executor: train: duty series (TPU_UTILIZATION per "
        f"{EXECUTOR_INTERVAL_MS} ms push) {duty}; MAX_TPU_HBM_BYTES series "
        f"(GiB) {[None if h is None else round(h / 2**30, 3) for h in hbm]}"
        f"; {smi}")
    log(_timing_line("train", run, smi))
    return {k: int(launched[0][k]) for k in want}


def _executor_wedge(am, root, conf_path, reader, smi: str) -> None:
    """(b) A task that makes a context, allocates 1 GiB, runs one kernel
    and sleeps: duty < 1 in at least 4 consecutive pushes while the
    heartbeats flow, and its memory reported."""
    sleep_s = EXECUTOR_WEDGE_INTERVALS * EXECUTOR_INTERVAL_MS / 1000.0
    script = os.path.join(root, "wedge.py")
    with open(script, "w") as f:
        f.write(WEDGE_COMMAND)
    run = _run_executor(am, root, conf_path, "worker",
                        f"{sys.executable} {script} {sleep_s}", reader,
                        "wedged")
    check(run["rc"] == 0 and [r["exit_code"] for r in run["results"]]
          == [0], f"executor: wedged: exit {run['rc']}, results "
                  f"{run['results']}")
    duty = _series(run, "TPU_UTILIZATION")
    hbm = _series(run, "MAX_TPU_HBM_BYTES")
    check(any(d is not None for d in duty),
          f"executor: the card yielded no duty sample for the wedge: "
          f"{duty}")
    best = run_len = 0
    for d in duty:
        run_len = run_len + 1 if d is not None and d < 1.0 else 0
        best = max(best, run_len)
    check(best >= 4, f"executor: TPU_UTILIZATION < 1 in at most {best} "
                     f"consecutive pushes: {duty}")
    max_hbm = max(h for h in hbm if h is not None)
    check(max_hbm >= 2**30, f"executor: wedged: MAX_TPU_HBM_BYTES "
                            f"{max_hbm:.0f} < 1 GiB")
    gap = _hb_gap_s(run, run["pushes"][-1][0])
    check(gap <= 5 * EXECUTOR_INTERVAL_MS / 1000.0,
          f"executor: wedged: heartbeats stopped for {gap:.2f} s")
    log(f"executor: wedged: a context, 1 GiB, one kernel, then "
        f"{sleep_s:.1f} s asleep: TPU_UTILIZATION {duty} ({best} "
        f"consecutive pushes < 1) while {len(run['heartbeats'])} "
        f"heartbeats arrived (longest gap {gap:.2f} s); MAX_TPU_HBM_BYTES "
        f"{max_hbm / 2**30:.3f} GiB; {smi}")
    log(_timing_line("wedged", run, smi))


def _executor_serve(am, root, conf_path, reader, smi: str) -> None:
    """(c) `python -m tony_tpu_torch.serve` as the serving jobtype: its
    endpoint registered at the SERVING_PORT the executor rendered (the
    port it registered at the barrier), one /v1/generate answered, and
    SIGTERM to the executor draining it: a draining re-registration, the
    server gone, and the executor's exit the killed-by-AM code the
    backend records."""
    from tony_tpu_torch import constants as C

    seen: dict = {}

    def during(proc, cwd):
        deadline = time.monotonic() + EXECUTOR_TASK_S
        while time.monotonic() < deadline and not am.take(
                "register_serving_endpoint"):
            check(proc.poll() is None,
                  f"executor: serving: the executor exited {proc.poll()}")
            time.sleep(0.2)
        regs = am.take("register_serving_endpoint")
        check(regs, "executor: serving: no endpoint registered")
        url = regs[0][1]["url"]
        seen["url"] = url
        t0 = time.monotonic()
        out = _post(url, {"prompt": [1, 2, 3, 4, 5, 6, 7, 8],
                          "max_new_tokens": 8}, stream=False)
        seen["generate_ms"] = (time.monotonic() - t0) * 1e3
        seen["tokens"] = out.get("tokens")
        proc.send_signal(signal.SIGTERM)

    command = (f"{sys.executable} -m tony_tpu_torch.serve --config "
               f"{TRAIN_CONFIG}")
    run = _run_executor(am, root, conf_path, "serving", command, reader,
                        "serving", during=during)
    registered = run["registrations"][-1]["spec"]
    url = seen["url"]
    check(url.rsplit(":", 1)[1] == registered.rsplit(":", 1)[1],
          f"executor: serving: endpoint {url} is not at the registered "
          f"{registered}")
    check(isinstance(seen.get("tokens"), list) and len(seen["tokens"]) == 8,
          f"executor: serving: /v1/generate answered {seen.get('tokens')}")
    drains = [r for r in run["endpoints"] if r.get("draining")]
    check(drains and drains[-1]["url"] == url,
          f"executor: serving: no draining re-registration: "
          f"{run['endpoints']}")
    want_rc = C.EXIT_KILLED_BY_AM & 0xFF
    check(run["rc"] == want_rc and not _listening(int(url.rsplit(":", 1)[1])),
          f"executor: serving: the executor exited {run['rc']} (want "
          f"{want_rc}) or the server still listens")
    log(f"executor: serving: {TRAIN_CONFIG} at {url} (the executor's "
        f"registered {registered}, rendered as SERVING_PORT); /v1/generate "
        f"(the server's first request) 8 tokens in "
        f"{seen['generate_ms']:.1f} ms; SIGTERM to the executor: "
        f"a draining re-registration of {url}, the server closed, the "
        f"executor exited {run['rc']} (EXIT_KILLED_BY_AM & 0xFF, the code "
        f"the backend reports); {smi}")
    log(_timing_line("serving", run, smi))


def phase_executor(smi: str) -> dict[str, int]:
    """`python -m tony_tpu_torch.executor` for three tasks against the
    recording AM, with the card read through NVML. Returns the training
    task's own count of its launches."""
    import secrets
    import statistics

    import torch

    from tony_tpu_torch.executor.cuda_metrics import (
        CardSampler, NvmlReader,
    )

    reader = NvmlReader()
    devices = reader.sample()
    check(devices, "executor: NVML shows no card")
    total = devices[0].memory_total
    costs, sampler_costs = [], []
    sampler = CardSampler(NvmlReader())
    for _ in range(100):
        t0 = time.perf_counter()
        reader.sample()
        costs.append((time.perf_counter() - t0) * 1e6)
        t0 = time.perf_counter()
        sampler(os.getpid())
        sampler_costs.append((time.perf_counter() - t0) * 1e6)
    log(f"executor: one NVML read of {len(devices)} card(s) (utilization, "
        f"memory, compute processes): median {statistics.median(costs):.1f}"
        f" us of 100; the monitor's whole card sample (that read on its "
        f"worker thread, the /proc tree walk, the attribution): median "
        f"{statistics.median(sampler_costs):.1f} us; card {devices[0].minor}"
        f" holds {devices[0].memory_total / 2**30:.1f} GiB; {smi}")
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="chip-smoke-executor-")
    am = _AmStandIn(secrets.token_hex(32))
    conf = _write_conf(os.path.join(root, "tony-final.json"), {
        "tony.application.framework": "pytorch",
        "tony.task.metrics-interval-ms": EXECUTOR_INTERVAL_MS,
        "tony.task.heartbeat-interval-ms": EXECUTOR_INTERVAL_MS,
        "tony.task.registration-timeout-sec": 60})
    serve_conf = _write_conf(os.path.join(root, "tony-final-serve.json"), {
        "tony.task.metrics-interval-ms": EXECUTOR_INTERVAL_MS,
        "tony.task.heartbeat-interval-ms": EXECUTOR_INTERVAL_MS,
        "tony.task.registration-timeout-sec": 60,
        "tony.serving.slots": 2, "tony.serving.token-budget": 256})
    t0 = time.monotonic()
    try:
        launches = _executor_train(am, root, conf, reader, total, smi)
        _executor_wedge(am, root, conf, reader, smi)
        # a serving-only application, on the default framework (jax: the
        # pytorch runtime needs a worker jobtype in the spec)
        _executor_serve(am, root, serve_conf, reader, smi)
    finally:
        am.stop()
        reader.close()
        shutil.rmtree(root, ignore_errors=True)
    log(f"executor: three tasks in {time.monotonic() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 15: whole jobs under the port's ApplicationMaster
# ---------------------------------------------------------------------------

AM_INTERVAL_MS = 500
AM_TRAIN_STEPS = 6
AM_JOB_S = 300.0
AM_SERVE_TOKENS = 16
# the record of a one-worker training job under the port's AM, as the am
# phase's job writes it (TASK_FINISHED left out: whether the last one
# lands before the AM stops is a race of the JAX AM too)
TRAIN_JOB_EVENTS = ["APPLICATION_INITED", "TASK_STARTED",
                    "APPLICATION_FINISHED"]
# the AM's own cadences, and no wait for a client at the end
AM_CONF = {"tony.am.monitor-interval-ms": 200,
           "tony.task.heartbeat-interval-ms": AM_INTERVAL_MS,
           "tony.task.metrics-interval-ms": AM_INTERVAL_MS,
           "tony.task.registration-timeout-sec": 120,
           "tony.am.stop-poll-timeout-ms": 0}


def _am_tree(root: str) -> tuple[str, dict[str, str]]:
    """A directory holding a copy of `tony_tpu_torch/` alone, the env that
    runs the AM from it (PYTHONPATH that directory, every task variable of
    earlier phases removed) and a kernel build cache whose libraries are
    the build phase's. `import tony_tpu` must fail under that env."""
    from tony_tpu_torch.ops import cuda_lib
    from tony_tpu_torch.utils.compilecache import KERNELS_SUBDIR

    repo = Path(__file__).resolve().parent
    lone = os.path.join(root, "lone")
    shutil.copytree(repo / "tony_tpu_torch",
                    os.path.join(lone, "tony_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__", "_build"))
    cache = os.path.join(root, "cache")
    os.makedirs(cache)
    os.makedirs(cuda_lib.BUILD_DIR, exist_ok=True)
    os.symlink(str(cuda_lib.BUILD_DIR), os.path.join(cache, KERNELS_SUBDIR))
    env = {k: v for k, v in os.environ.items()
           if k not in ("AM_HOST", "AM_PORT", "METRICS_RPC_PORT",
                        "JOB_NAME", "TASK_INDEX", "TONY_SECURITY_TOKEN",
                        "TONY_TRACE_ID", "TONY_PARENT_SPAN", "TB_PORT",
                        "IS_CHIEF", "RANK", "WORLD", "INIT_METHOD",
                        "TONY_JAX_CACHE_DIR", "TONY_CONF_PATH",
                        "PYTHONPATH")}
    env["PYTHONPATH"] = lone
    probe = subprocess.run(
        [sys.executable, "-c", "import tony_tpu_torch.am, tony_tpu"],
        cwd=root, env=env, capture_output=True, text=True, timeout=120)
    check(probe.returncode != 0 and "No module named 'tony_tpu'"
          in probe.stderr, f"am: tony_tpu importable beside the copy: "
                           f"{probe.stderr[-1000:]}")
    return cache, env


def _am_start(root: str, env: dict, app_id: str, values: dict):
    """`python -m tony_tpu_torch.am` on a conf the port's
    TonyConfiguration froze; returns (app dir, process, spawn time)."""
    from tony_tpu_torch import constants as C
    from tony_tpu_torch.conf import TonyConfiguration

    app_dir = os.path.join(root, app_id)
    os.makedirs(app_dir)
    conf = TonyConfiguration()
    for k, v in {**AM_CONF, **values}.items():
        conf.set(k, v, "chip_smoke")
    conf.write(os.path.join(app_dir, C.TONY_FINAL_CONF))
    t_spawn = time.time()
    with open(os.path.join(app_dir, "am.stdout"), "w") as out, \
            open(os.path.join(app_dir, "am.stderr"), "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "tony_tpu_torch.am", "--app_id", app_id,
             "--app_dir", app_dir], cwd=app_dir, env=env, stdout=out,
            stderr=err, start_new_session=True)
    return app_dir, proc, t_spawn


def _am_wait(proc, app_dir: str, what: str) -> int:
    try:
        return proc.wait(timeout=AM_JOB_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)
        with open(os.path.join(app_dir, "am.stderr")) as f:
            tail = f.read()[-3000:]
        raise SmokeFailure(f"am: {what}: the AM ran past {AM_JOB_S:.0f} s:"
                           f"\n{tail}")


def _am_history(app_dir: str, app_id: str) -> tuple[list, str]:
    """The job's events, parsed by the port's handler, and its history
    directory."""
    from tony_tpu_torch import constants as C
    from tony_tpu_torch.events.handler import parse_events

    hist = os.path.join(app_dir, C.HISTORY_DIR_NAME, app_id)
    finals = [f for f in os.listdir(hist)
              if f.endswith("." + C.HISTORY_SUFFIX)]
    check(len(finals) == 1, f"am: {app_id}: history files {finals}")
    return parse_events(os.path.join(hist, finals[0])), hist


def _am_task_log(app_dir: str, task: str, stream: str) -> str:
    from tony_tpu_torch import constants as C
    with open(os.path.join(app_dir, C.CONTAINERS_DIR_NAME, f"{task}_s0",
                           stream)) as f:
        return f.read()


def _am_launches(stderr: str, what: str) -> dict[str, int]:
    counts = [json.loads(m[len("kernel launches "):])
              for m in _log_messages(stderr)
              if m.startswith("kernel launches ")]
    check(len(counts) == 1, f"am: {what}: launch lines {counts}")
    return {k: int(v) for k, v in counts[0].items()}


def _am_first(events: list, etype: str):
    found = [e for e in events if e.type.name == etype]
    check(found, f"am: no {etype} in {[e.type.name for e in events]}")
    return found[0]


def _am_train(root: str, env: dict, cache: str, smi: str) -> dict[str, int]:
    """(a) The trainer as the job's one pytorch worker."""
    from tony_tpu_torch import constants as C
    from tony_tpu_torch.models.llama import get_config

    app_id = "application_chip_smoke_train"
    command = (f"{sys.executable} -m tony_tpu_torch.train --config "
               f"{TRAIN_CONFIG} --batch-size {TRAIN_BATCH} --seq-len "
               f"{TRAIN_SEQ} --steps {AM_TRAIN_STEPS} --log-every 1")
    app_dir, proc, t_spawn = _am_start(root, env, app_id, {
        "tony.worker.instances": 1,
        "tony.application.framework": "pytorch",
        "tony.task.command": command,
        "tony.executor.jax-cache-dir": cache})
    rc = _am_wait(proc, app_dir, "train")
    wall = time.time() - t_spawn
    with open(os.path.join(app_dir, "status.json")) as f:
        status = json.load(f)
    stderr = _am_task_log(app_dir, "worker_0", "stderr")
    check(rc == 0 and status["status"] == "SUCCEEDED",
          f"am: train: the AM exited {rc}, {status}; the task's stderr:\n"
          f"{stderr[-3000:]}")
    events, hist = _am_history(app_dir, app_id)
    names = [e.type.name for e in events]
    check([n for n in names if n != "TASK_FINISHED"] == TRAIN_JOB_EVENTS,
          f"am: train: events {names}, want {TRAIN_JOB_EVENTS} with "
          f"TASK_FINISHED left out")
    launched = _am_launches(stderr, "train")
    per_step = _step_launches(get_config(TRAIN_CONFIG).n_layers)
    want = {k: AM_TRAIN_STEPS * v for k, v in per_step.items()}
    check({k: launched.get(k) for k in want} == want,
          f"am: train: the trainer launched {launched}, want {want}")
    check("nvcc compiled" not in stderr,
          "am: train: the task compiled a kernel the cache held")
    with open(os.path.join(hist, C.METRICS_FILE)) as f:
        series = json.load(f).get("worker:0", {})
    duty = [v for _, v in series.get("TPU_UTILIZATION", [])]
    check(duty and max(duty) >= 90.0,
          f"am: train: the AM received no TPU_UTILIZATION >= 90: {duty}")
    first = _am_first(events, "TASK_STARTED").timestamp / 1000.0
    log(f"am: train: {TRAIN_CONFIG} B{TRAIN_BATCH} x S{TRAIN_SEQ}, "
        f"{AM_TRAIN_STEPS} steps as the job's pytorch worker: SUCCEEDED; "
        f"events {names}; the trainer's own count of its launches "
        f"{launched} (= {AM_TRAIN_STEPS} x the train phase's step); the "
        f"AM's TPU_UTILIZATION series {duty}; {smi}")
    log(f"am: train: AM start -> first container launch "
        f"{(first - t_spawn) * 1e3:.0f} ms, the job's wall {wall:.2f} s "
        f"(AM spawn to AM exit); {smi}")
    return {k: launched.get(k, 0) for k in per_step}


def _am_serve(root: str, env: dict, cache: str, smi: str) -> dict[str, int]:
    """(b) One serving task: SERVING_UP, one /v1/generate, SIGTERM to the
    AM."""
    app_id = "application_chip_smoke_serve"
    app_dir, proc, t_spawn = _am_start(root, env, app_id, {
        "tony.serving.instances": 1,
        "tony.serving.command": f"{sys.executable} -m tony_tpu_torch.serve "
                                f"--config {TRAIN_CONFIG}",
        "tony.serving.slots": 2, "tony.serving.token-budget": 256,
        # the server drains in well under a second; the default 15 s
        # grace would hold the AM's teardown that long
        "tony.task.term-grace-ms": 2000,
        "tony.executor.jax-cache-dir": cache})
    url = ""
    try:
        deadline = time.monotonic() + AM_JOB_S
        while not url and time.monotonic() < deadline:
            check(proc.poll() is None,
                  f"am: serve: the AM exited {proc.poll()} before "
                  f"SERVING_UP")
            try:
                for line in _am_task_log(app_dir, "serving_0",
                                         "stdout").splitlines():
                    if line.startswith("SERVING_UP "):
                        url = line.split()[1]
            except FileNotFoundError:
                pass
            time.sleep(0.2)
        check(url, "am: serve: no SERVING_UP within the job's limit")
        t0 = time.monotonic()
        out = _post(url, {"prompt": [1, 2, 3, 4, 5, 6, 7, 8],
                          "max_new_tokens": AM_SERVE_TOKENS}, stream=False)
        generate_ms = (time.monotonic() - t0) * 1e3
        tokens = out.get("tokens")
        check(isinstance(tokens, list) and len(tokens) == AM_SERVE_TOKENS,
              f"am: serve: /v1/generate answered {tokens}")
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
    rc = _am_wait(proc, app_dir, "serve")
    port = int(url.rsplit(":", 1)[1])
    check(not _listening(port), f"am: serve: {url} still listens after "
                                f"the AM exited {rc}")
    events, _ = _am_history(app_dir, app_id)
    names = [e.type.name for e in events]
    registered = _am_first(events, "SERVING_ENDPOINT_REGISTERED")
    check(registered.payload.url == url,
          f"am: serve: registered {registered.payload.url}, SERVING_UP {url}")
    launched = _am_launches(_am_task_log(app_dir, "serving_0", "stderr"),
                            "serve")
    check(launched.get("flash_fwd", 0) > 0
          and launched.get("rmsnorm_fwd", 0) > 0
          and launched.get("decode_attention", 0) > 0,
          f"am: serve: the server launched {launched}")
    with open(os.path.join(app_dir, "status.json")) as f:
        status = json.load(f)
    started = _am_first(events, "TASK_STARTED").timestamp / 1000.0
    log(f"am: serve: {TRAIN_CONFIG}, 2 slots, at {url}: /v1/generate "
        f"{AM_SERVE_TOKENS} tokens in {generate_ms:.1f} ms; SIGTERM to the "
        f"AM: it exited {rc} ({status['status']}), the port closed; events "
        f"{names}; the server's own count of its launches {launched}; "
        f"{smi}")
    log(f"am: serve: AM start -> first container launch "
        f"{(started - t_spawn) * 1e3:.0f} ms, container launch -> "
        f"SERVING_ENDPOINT_REGISTERED "
        f"{registered.timestamp / 1000.0 - started:.2f} s; {smi}")
    return launched


def phase_am(smi: str) -> dict[str, int]:
    """Two jobs under `python -m tony_tpu_torch.am`, with no module of
    tony_tpu importable. Returns the trainer's and the server's own
    counts of their launches, summed."""
    import torch

    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="chip-smoke-am-")
    t0 = time.monotonic()
    try:
        cache, env = _am_tree(root)
        train = _am_train(root, env, cache, smi)
        serve = _am_serve(root, env, cache, smi)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"am: two jobs in {time.monotonic() - t0:.1f} s")
    return {k: train.get(k, 0) + serve.get(k, 0)
            for k in set(train) | set(serve)}


# ---------------------------------------------------------------------------
# phase 16: whole jobs submitted through the port's CLI
# ---------------------------------------------------------------------------

CLI_TRAIN_STEPS = 2
CLI_JOB_S = 300.0


def _cli_spans(app_dir: str, app_id: str) -> dict[str, dict]:
    from tony_tpu_torch import constants as C
    with open(os.path.join(app_dir, C.HISTORY_DIR_NAME, app_id,
                           "spans.json")) as f:
        return {s["name"]: s for s in json.load(f)}


def _submit(root: str, env: dict, tag: str, conf: dict, executes: str):
    """`python -m tony_tpu_torch.cli submit` in its own session, its
    output in `<root>/<tag>.cli.log`."""
    argv = [sys.executable, "-m", "tony_tpu_torch.cli", "submit"]
    if executes:
        argv += ["--executes", executes]
    for k, v in conf.items():
        argv += ["--conf", f"{k}={v}"]
    with open(os.path.join(root, f"{tag}.cli.log"), "w") as out:
        return subprocess.Popen(argv, cwd=root, env=env, stdout=out,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)


def _cli_job(root: str, env: dict, cache: str, tag: str,
             extra: dict) -> dict:
    """`python -m tony_tpu_torch.cli submit` of one training job, with
    `cli logs <app> worker:0 --follow` started beside it once the
    worker's container exists. Returns what the checks read."""
    from tony_tpu_torch import constants as C

    workdir = os.path.join(root, tag)
    command = (f"{sys.executable} -m tony_tpu_torch.train --config "
               f"{TRAIN_CONFIG} --batch-size {TRAIN_BATCH} --seq-len "
               f"{TRAIN_SEQ} --steps {CLI_TRAIN_STEPS} --log-every 1")
    # the AM keeps its default wait for the client's finish_application:
    # with none, it stops its RPC server as it writes status.json, and the
    # client's last task-info and finish calls wait out their deadlines
    conf = {**{k: v for k, v in AM_CONF.items()
               if k != "tony.am.stop-poll-timeout-ms"},
            "tony.worker.instances": 1,
            "tony.application.framework": "pytorch",
            "tony.cluster.workdir": workdir,
            "tony.executor.jax-cache-dir": cache, **extra}
    cli_log = os.path.join(root, f"{tag}.cli.log")
    logs_out = os.path.join(root, f"{tag}.logs.out")
    t_spawn = time.time()
    proc = _submit(root, env, tag, conf, command)
    follower = None
    try:
        deadline = time.monotonic() + CLI_JOB_S
        while time.monotonic() < deadline and proc.poll() is None:
            found = glob.glob(os.path.join(
                workdir, "application_*", C.CONTAINERS_DIR_NAME,
                "worker_0_s0", "stderr"))
            if found:
                app_dir = found[0].split(os.sep + C.CONTAINERS_DIR_NAME)[0]
                with open(logs_out, "w") as out:
                    follower = subprocess.Popen(
                        [sys.executable, "-m", "tony_tpu_torch.cli", "logs",
                         app_dir, "worker:0", "--follow"], cwd=root,
                        env=env, stdout=out, stderr=subprocess.STDOUT,
                        start_new_session=True)
                break
            time.sleep(0.05)
        rc = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
        wall = time.time() - t_spawn
        if follower is not None:
            follower.wait(timeout=60)
    except subprocess.TimeoutExpired:
        raise SmokeFailure(f"cli: {tag}: the job or its log follower ran "
                           f"past {CLI_JOB_S:.0f} s")
    finally:
        for p in (proc, follower):
            if p is not None and p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait(timeout=30)
    with open(cli_log) as f:
        client_log = f.read()
    check(follower is not None, f"cli: {tag}: no worker container "
                                f"appeared; the CLI said:\n"
                                f"{client_log[-3000:]}")
    [app_dir] = glob.glob(os.path.join(workdir, "application_*"))
    app_id = os.path.basename(app_dir)
    with open(os.path.join(app_dir, C.AM_STATUS_FILE)) as f:
        status = json.load(f)
    stderr = _am_task_log(app_dir, "worker_0", "stderr")
    check(rc == 0 and status["status"] == "SUCCEEDED",
          f"cli: {tag}: the CLI exited {rc}, {status}; the CLI said:\n"
          f"{client_log[-2000:]}\nthe task's stderr:\n{stderr[-3000:]}")
    with open(os.path.join(app_dir, C.AM_STDERR)) as f:
        am_log = f.read()
    with open(logs_out) as f:
        followed = f.read()
    return {"app_dir": app_dir, "app_id": app_id, "t_spawn": t_spawn,
            "wall": wall, "stderr": stderr, "am_log": am_log,
            "followed": followed, "follower_rc": follower.returncode,
            "spans": _cli_spans(app_dir, app_id)}


def _cli_timing(tag: str, job: dict, smi: str) -> None:
    spans = job["spans"]
    app, task = spans["application"], spans["task:worker:0"]
    submit, user = spans["client_submit"], spans["user_process"]
    t_exit_ms = 1000 * (job["t_spawn"] + job["wall"])
    log(f"cli: {tag}: CLI spawn -> AM start "
        f"{app['start_ms'] - 1000 * job['t_spawn']:.0f} ms (client_submit "
        f"span {submit['end_ms'] - submit['start_ms']} ms), AM start -> "
        f"first container launch {task['start_ms'] - app['start_ms']} ms, "
        f"container launch -> user process start "
        f"{user['start_ms'] - task['start_ms']} ms, the user process "
        f"{(user['end_ms'] - user['start_ms']) / 1e3:.2f} s, its end -> "
        f"the application span's end "
        f"{app['end_ms'] - user['end_ms']} ms -> CLI exit "
        f"{t_exit_ms - app['end_ms']:.0f} ms; the job's wall "
        f"{job['wall']:.2f} s (CLI spawn to CLI exit); {smi}")


def _cli_launches(tag: str, job: dict) -> dict[str, int]:
    from tony_tpu_torch.models.llama import get_config

    launched = _am_launches(job["stderr"], f"cli {tag}")
    per_step = _step_launches(get_config(TRAIN_CONFIG).n_layers)
    want = {k: CLI_TRAIN_STEPS * v for k, v in per_step.items()}
    check({k: launched.get(k) for k in want} == want,
          f"cli: {tag}: the trainer launched {launched}, want {want}")
    check("nvcc compiled" not in job["stderr"],
          f"cli: {tag}: the task compiled a kernel the cache held")
    return {k: launched.get(k, 0) for k in per_step}


def _cli_warm(root: str, env: dict, cache: str, smi: str) -> dict[str, int]:
    """(a) The local backend with one warm executor child."""
    job = _cli_job(root, env, cache, "warm", {
        "tony.warmpool.enabled": "true", "tony.warmpool.size": 1})
    leases = [m for m in _log_messages(job["am_log"])
              if m.startswith("leased warm executor for ")]
    check(len(leases) == 1, f"cli: warm: the AM's lease lines {leases}")
    launched = _cli_launches("warm", job)
    check(job["follower_rc"] == 0 and any(
        m.startswith("kernel launches ")
        for m in _log_messages(job["followed"])),
        f"cli: warm: `cli logs --follow` exited {job['follower_rc']} "
        f"without the trainer's launch line:\n{job['followed'][-2000:]}")
    diag = subprocess.run(
        [sys.executable, "-m", "tony_tpu_torch.cli", "diagnose",
         job["app_dir"]], cwd=root, env=env, capture_output=True,
        text=True, timeout=120)
    check(diag.returncode == 1 and "no diagnostics bundle found"
          in diag.stderr and "first failing task" not in diag.stdout,
          f"cli: warm: `cli diagnose` exited {diag.returncode}: "
          f"{diag.stdout[-1000:]}{diag.stderr[-1000:]}")
    alerts = subprocess.run(
        [sys.executable, "-m", "tony_tpu_torch.cli", "alerts",
         job["app_dir"]], cwd=root, env=env, capture_output=True,
        text=True, timeout=120)
    # no alert rule is set, so the AM built no engine and wrote no bundle
    check(alerts.returncode == 1
          and "no alert bundle found" in alerts.stderr,
          f"cli: warm: `cli alerts` exited {alerts.returncode}: "
          f"{alerts.stderr[-1000:]}")
    log(f"cli: warm: {TRAIN_CONFIG} B{TRAIN_BATCH} x S{TRAIN_SEQ}, "
        f"{CLI_TRAIN_STEPS} steps through `cli submit` on the local "
        f"backend with one warm executor: SUCCEEDED; {leases[0]}; the "
        f"trainer's own count of its launches {launched}; `cli logs "
        f"--follow` carried its launch line; `cli diagnose`: no failure "
        f"record; `cli alerts`: no bundle, exit 1; {smi}")
    _cli_timing("warm", job, smi)
    return launched


def _cli_remote(root: str, env: dict, cache: str,
                smi: str) -> dict[str, int]:
    """(b) The remote backend over the exec transport, two nodes on this
    host, staged through a local staging location."""
    from tony_tpu_torch import constants as C
    from tony_tpu_torch.observability.fleet import job_summary

    nodes, stage = os.path.join(root, "nodes"), os.path.join(root, "stage")
    job = _cli_job(root, env, cache, "remote", {
        "tony.cluster.backend": "remote",
        "tony.cluster.node-transport": "exec",
        "tony.cluster.nodes": "nodeA:1,nodeB:1",
        "tony.cluster.node-root": nodes,
        "tony.staging.location": stage,
        "tony.fleet.publish-interval-ms": 1000})
    launches = [m for m in _log_messages(job["am_log"])
                if m.startswith("launched container_")]
    check(len(launches) == 1, f"cli: remote: launch lines {launches}")
    cid = launches[0].split()[1]
    workdir = os.path.join(nodes, cid)
    check(f"(workdir {workdir})" in launches[0] and os.path.isdir(workdir),
          f"cli: remote: {launches[0]}; want the workdir {workdir}")
    staged = os.path.join(stage, job["app_id"], C.TONY_FINAL_CONF)
    fetched = os.path.join(workdir, C.TONY_FINAL_CONF)
    check(os.path.exists(staged) and os.path.exists(fetched),
          f"cli: remote: staged conf {os.path.exists(staged)}, fetched "
          f"into the workdir {os.path.exists(fetched)}")
    with open(staged, "rb") as a, open(fetched, "rb") as b:
        check(a.read() == b.read(),
              "cli: remote: the worker's conf differs from the store's")
    with open(os.path.join(stage, job["app_id"], C.FLEET_DIR_NAME,
                           C.JOBSTATE_FILE)) as f:
        jobstate = json.load(f)
    want_keys = sorted(job_summary("a", "u", "q", "RUNNING"))
    check(sorted(jobstate) == want_keys
          and jobstate["state"] == "SUCCEEDED"
          and jobstate["gang_width"] == 1,
          f"cli: remote: fleet/jobstate.json {jobstate}")
    launched = _cli_launches("remote", job)
    log(f"cli: remote: the same job on the remote backend (exec "
        f"transport, nodes nodeA and nodeB under {nodes}), staged "
        f"through {stage}: SUCCEEDED; {launches[0]}; the worker read the "
        f"conf it fetched from the store ({os.path.getsize(fetched)} "
        f"bytes, equal to the store's); fleet/jobstate.json "
        f"{jobstate['state']} with {len(jobstate)} keys; the trainer's "
        f"own count of its launches {launched}; {smi}")
    _cli_timing("remote", job, smi)
    return launched


def phase_cli(smi: str) -> dict[str, int]:
    """Two jobs through `python -m tony_tpu_torch.cli submit`, with no
    module of tony_tpu importable. Returns the trainer's own counts of
    its launches in both, summed."""
    import torch

    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="chip-smoke-cli-")
    t0 = time.monotonic()
    try:
        cache, env = _am_tree(root)
        warm = _cli_warm(root, env, cache, smi)
        remote = _cli_remote(root, env, cache, smi)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"cli: two jobs in {time.monotonic() - t0:.1f} s; {smi}")
    return {k: warm.get(k, 0) + remote.get(k, 0)
            for k in set(warm) | set(remote)}


# ---------------------------------------------------------------------------
# phase 17: a served model scaled from one replica to two behind `cli router`
# ---------------------------------------------------------------------------

FLEET_CONFIG = TRAIN_CONFIG
FLEET_SLOTS = 2
FLEET_REQUESTS, FLEET_PROMPT, FLEET_NEW = 16, 256, 64
FLEET_SEED = 18
FLEET_JOB_S = 300.0
FLEET_QUEUE_SLO = 4
# the second tenant must be in the book before the cooldown after the
# admitted scale-up ends; burst B waits for the cooldown's end
FLEET_COOLDOWN_MS = 20000
FLEET_PAIRS = 30
# a burst's requests start this far apart, so the router's load probes
# (refreshed every 25 ms at a 100 ms TTL) see each one queue; the router
# counts no dispatch between probes, so a burst with no gap goes to the
# replica the last probe ranked first (measured, not held)
FLEET_GAP_S = 0.04


def _fleet_conf(cache: str, workdir: str, stage: str) -> dict:
    """The served job: one replica of 2 slots asking 1 chip, the
    autoscaler on (1 to 3 replicas, up on a queue of more than 2 a
    replica for 2 passes, never down), the arbiter's inventory 2
    chips, the queue-depth alert at 4 with 2 s / 4 s burn windows, the
    AM's monitor every 300 ms and the replicas' pushes every 300 ms."""
    return {**{k: v for k, v in AM_CONF.items()
               if k != "tony.am.stop-poll-timeout-ms"},
            "tony.am.monitor-interval-ms": 300,
            "tony.task.metrics-interval-ms": 300,
            "tony.cluster.workdir": workdir,
            "tony.executor.jax-cache-dir": cache,
            "tony.task.term-grace-ms": 3000,
            "tony.serving.instances": 1, "tony.serving.tpus": 1,
            "tony.serving.slots": FLEET_SLOTS,
            "tony.serving.token-budget": FLEET_PROMPT + FLEET_NEW,
            "tony.serving.command": f"{sys.executable} -m "
                                    f"tony_tpu_torch.serve --config "
                                    f"{FLEET_CONFIG} --device cuda",
            "tony.staging.location": stage,
            "tony.fleet.publish-interval-ms": 500,
            "tony.autoscaler.enabled": "true",
            "tony.autoscaler.min-replicas": 1,
            "tony.autoscaler.max-replicas": 3,
            "tony.autoscaler.queue-depth-up": 2,
            "tony.autoscaler.hysteresis-passes": 2,
            "tony.autoscaler.cooldown-ms": FLEET_COOLDOWN_MS,
            # no scale-down: the idle gaps between the bursts would drain
            # the second replica
            "tony.autoscaler.occupancy-down-pct": 0,
            "tony.arbiter.total-tpus": 2,
            "tony.alerts.queue-depth-slo": FLEET_QUEUE_SLO,
            "tony.alerts.for-ms": 500,
            "tony.alerts.fast-window-ms": 2000,
            "tony.alerts.slow-window-ms": 4000,
            "tony.alerts.flap-suppress-ms": 0}


def _fleet_events(app_dir: str) -> list:
    """The job's events so far, from the history file the AM appends
    to (the final file once the AM has renamed it)."""
    from tony_tpu_torch import constants as C
    from tony_tpu_torch.events.handler import parse_events
    found = glob.glob(os.path.join(app_dir, C.HISTORY_DIR_NAME, "*",
                                   "*.jhist*"))
    return parse_events(found[0]) if found else []


class _Waiter:
    """Polls a condition under the phase's deadline, failing the phase
    (with the processes' state) when it runs out."""

    def __init__(self, procs: dict):
        self.procs = procs
        self.deadline = time.monotonic() + FLEET_JOB_S

    def until(self, cond, what: str, poll: float = 0.05):
        while True:
            got = cond()
            if got:
                return got
            for name, proc in list(self.procs.items()):
                check(proc.poll() is None,
                      f"fleet: {name} exited {proc.poll()} waiting for "
                      f"{what}")
            check(time.monotonic() < self.deadline,
                  f"fleet: no {what} within {FLEET_JOB_S:.0f} s")
            time.sleep(poll)


def _of(events: list, etype: str, **match) -> list:
    return [e for e in events if e.type.name == etype
            and all(getattr(e.payload, k) == v for k, v in match.items())]


def _get_json(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


def _burst(url: str, prompts: list, gap_s: float = FLEET_GAP_S) -> dict:
    """Every prompt streamed, each started `gap_s` after the last, all
    in flight together; returns the answers, the wall and its start and
    end on the wall clock (ms, as events are stamped)."""
    results: dict[int, object] = {}

    def run(i: int) -> None:
        try:
            results[i] = _post(url, {"prompt": prompts[i],
                                     "max_new_tokens": FLEET_NEW},
                               stream=True)
        except Exception as e:  # noqa: BLE001 — reported below
            results[i] = e

    t0, t0_ms = time.monotonic(), time.time() * 1000
    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
        time.sleep(gap_s)
    for t in threads:
        t.join(timeout=FLEET_JOB_S)
    out = [results.get(i) for i in range(len(prompts))]
    for i, r in enumerate(out):
        check(isinstance(r, dict) and len(r["tokens"]) == FLEET_NEW
              and r["finish_reason"] == "length",
              f"fleet: burst request {i}: {r!r}")
    return {"answers": out, "wall": time.monotonic() - t0,
            "start_ms": t0_ms, "end_ms": time.time() * 1000}


def _pct(values: list, q: float) -> float:
    v = sorted(values)
    return v[min(len(v) - 1, int(round(q * (len(v) - 1))))]


def _fleet_reference(prompts: list) -> list:
    """`generate` on the replicas' weights (the entry point's seed), in
    this process, one prompt at a time."""
    import torch

    from tony_tpu_torch.models.generate import generate
    from tony_tpu_torch.serve.__main__ import _load_model, build_arg_parser

    device = torch.device("cuda")
    params, cfg = _load_model(build_arg_parser().parse_args(
        ["--config", FLEET_CONFIG, "--device", "cuda"]), device)
    want = [generate(params, cfg, torch.tensor([p], device=device),
                     FLEET_NEW)[0].tolist() for p in prompts]
    del params
    torch.cuda.empty_cache()
    return want


def _fleet_job(root: str, env: dict, cache: str, smi: str) -> dict:
    from tony_tpu_torch import constants as C
    from tony_tpu_torch.models.llama import get_config

    import numpy as np

    cfg = get_config(FLEET_CONFIG)
    rng = np.random.RandomState(FLEET_SEED)
    prompts = [[int(t) for t in rng.randint(0, cfg.vocab_size,
                                            size=FLEET_PROMPT)]
               for _ in range(FLEET_REQUESTS)]
    workdir, stage = os.path.join(root, "work"), os.path.join(root, "stage")
    procs: dict = {}
    wait = _Waiter(procs)
    out: dict = {"prompts": prompts, "spawn_ms": time.time() * 1000}
    t_spawn = time.monotonic()
    marks: dict[str, float] = {}

    def mark(what: str) -> None:
        marks[what] = round(time.monotonic() - t_spawn, 2)
    procs["cli submit"] = _submit(root, env, "serve",
                                  _fleet_conf(cache, workdir, stage), "")
    router_log = os.path.join(root, "router.out")
    try:
        app_dir = wait.until(lambda: (glob.glob(os.path.join(
            workdir, "application_*")) or [None])[0], "application dir")
        out["app_dir"] = app_dir
        want = _fleet_reference(prompts)
        mark("generate")
        wait.until(lambda: _of(_fleet_events(app_dir),
                               "SERVING_ENDPOINT_REGISTERED",
                               task_index=0), "serving:0's registration")
        mark("serving:0")
        with open(router_log, "w") as f:
            procs["cli router"] = subprocess.Popen(
                [sys.executable, "-m", "tony_tpu_torch.cli", "router",
                 app_dir, "--port", "0", "--host", "127.0.0.1",
                 "--poll-ms", "300", "--probe-ttl-ms", "100"], cwd=root,
                env=env, stdout=f,
                stderr=subprocess.STDOUT, start_new_session=True)

        def router_up():
            with open(router_log) as f:
                return next((line.split()[1] for line in f
                             if line.startswith("ROUTER_UP ")), None)
        router = wait.until(router_up, "ROUTER_UP")
        out["router"] = router

        def up_endpoints(n):
            # all n endpoints UP with a load, not n listed with fewer UP
            def ready():
                eps = _get_json(router + "/v1/fleet")["endpoints"]
                ups = [e for e in eps if e["state"] == "UP" and e["load"]]
                return ups if len(eps) == n == len(ups) else []
            return ready
        [ep0] = wait.until(up_endpoints(1), "the router's first endpoint")
        mark("router")
        replicas = {0: ep0["url"]}

        # burst A: the holder job is submitted the moment the arbiter
        # admits the scale-up, so the book is full for every later ask
        holder = {}

        def holder_running():
            found = glob.glob(os.path.join(stage, "*", C.FLEET_DIR_NAME,
                                           C.JOBSTATE_FILE))
            for path in found:
                with open(path) as f:
                    js = json.load(f)
                if js["app_id"] != os.path.basename(app_dir) \
                        and js["state"] == "RUNNING":
                    return js
            return None

        def watch_scale_up():
            first = wait.until(lambda: _of(
                _fleet_events(app_dir), "AUTOSCALE_DECISION",
                direction="up"), "the scale-up decision")[0]
            holder["decision"] = first
            holder["t"] = time.monotonic()
            mark("scale-up")
            if first.payload.arbiter_action == "admit":
                procs["holder"] = _submit(root, env, "holder", {
                    **{k: v for k, v in AM_CONF.items()
                       if k != "tony.am.stop-poll-timeout-ms"},
                    "tony.cluster.workdir": os.path.join(root, "hold"),
                    "tony.staging.location": stage,
                    "tony.fleet.publish-interval-ms": 500,
                    "tony.worker.instances": 1, "tony.worker.tpus": 2},
                    f"{sys.executable} -c 'import time; time.sleep(600)'")
                holder["held"] = wait.until(holder_running,
                                            "the holder's jobstate")
                holder["after_s"] = time.monotonic() - holder["t"]
                mark("holder")
        watcher = threading.Thread(target=watch_scale_up, daemon=True)
        watcher.start()
        burst_a = _burst(router, prompts)
        mark("burst A done")
        watcher.join(timeout=FLEET_JOB_S)
        check("decision" in holder, "fleet: no scale-up during burst A")
        first = holder["decision"]
        check(first.payload.arbiter_action == "admit"
              and (first.payload.from_replicas,
                   first.payload.to_replicas) == (1, 2),
              f"fleet: the scale-up decision {first.payload}")

        check("held" in holder, "fleet: the holder's jobstate never "
                                "showed RUNNING")
        held = holder["held"]
        out["holder_after_s"] = holder["after_s"]
        check(out["holder_after_s"] * 1000 < FLEET_COOLDOWN_MS,
              f"fleet: the holder's jobstate came "
              f"{out['holder_after_s']:.2f} s after the scale-up, past the "
              f"{FLEET_COOLDOWN_MS} ms cooldown")
        reg1 = wait.until(lambda: _of(_fleet_events(app_dir),
                                      "SERVING_ENDPOINT_REGISTERED",
                                      task_index=1),
                          "serving:1's registration")[0]
        mark("serving:1")
        eps = wait.until(up_endpoints(2), "the router's second endpoint")
        replicas[1] = next(e["url"] for e in eps if e["url"] != ep0["url"])

        def alerts_clear():
            ev = _fleet_events(app_dir)
            fired = _of(ev, "ALERT_FIRING")
            return fired and len(_of(ev, "ALERT_RESOLVED")) >= len(fired)
        wait.until(alerts_clear, "ALERT_RESOLVED after burst A")
        cooled = holder["t"] + FLEET_COOLDOWN_MS / 1000 + 0.5
        time.sleep(max(0.0, cooled - time.monotonic()))
        mark("cooled")
        before = {i: _get_json(u + "/v1/metrics")
                  for i, u in replicas.items()}
        burst_b = _burst(router, prompts)
        mark("burst B done")
        after = {i: _get_json(u + "/v1/metrics")
                 for i, u in replicas.items()}
        wait.until(lambda: _of(_fleet_events(app_dir), "AUTOSCALE_DECISION",
                               arbiter_action="queue"),
                   "a queued AUTOSCALE_DECISION")
        mark("queued")
        # burst B again with no gap: the split the router gives requests
        # that arrive between two probes
        burst_b0 = _burst(router, prompts, gap_s=0.0)
        after0 = {i: _get_json(u + "/v1/metrics")
                  for i, u in replicas.items()}
        mark("burst B0 done")
        wait.until(alerts_clear, "ALERT_RESOLVED after burst B")
        mark("resolved")

        # the router's own wall: the same short request through the
        # router, then direct to the replica the router sent it to
        short = {"prompt": prompts[0][:16], "max_new_tokens": 1}

        def sent():
            return {e["url"]: e["sent"] for e in
                    _get_json(router + "/v1/fleet")["endpoints"]}
        pairs = []
        for _ in range(FLEET_PAIRS):
            s0 = sent()
            routed = _post(router, short, stream=False)["wall_s"]
            s1 = sent()
            went = [u for u in s1 if s1[u] != s0.get(u)]
            check(len(went) == 1, f"fleet: one routed request moved the "
                                  f"router's counts {s0} -> {s1}")
            direct = _post(went[0], short, stream=False)["wall_s"]
            pairs.append((direct, routed))

        def cli(*argv):
            r = subprocess.run([sys.executable, "-m", "tony_tpu_torch.cli",
                                *argv], cwd=root, env=env,
                               capture_output=True, text=True, timeout=120)
            return r.returncode, r.stdout, r.stderr
        arb_conf = os.path.join(root, "arbiter.properties")
        with open(arb_conf, "w") as f:
            f.write("tony.arbiter.total-tpus=2\n")
        out["cli"] = {"alerts": cli("alerts", app_dir),
                      "top": cli("top", stage, "--once"),
                      "arbiter": cli("arbiter", stage, "--chips", "1",
                                     "--queues-conf", arb_conf),
                      "router": cli("router", "--status", router)}
        final = {i: _get_json(u + "/v1/metrics")
                 for i, u in replicas.items()}
        mark("verbs")
    except SmokeFailure:
        log(f"fleet: seconds from the CLI's spawn: {marks}")
        for name in ("serve.cli.log", "holder.cli.log", "router.out"):
            path = os.path.join(root, name)
            if os.path.exists(path):
                with open(path) as f:
                    log(f"fleet: {name}:\n{f.read()[-3000:]}")
        for path in glob.glob(os.path.join(workdir, "application_*",
                                           C.AM_STDERR)):
            with open(path) as f:
                log(f"fleet: {path}:\n" + "\n".join(
                    m for m in _log_messages(f.read())
                    if "autoscal" in m or "alert" in m or "arbiter" in m
                    or "fleet" in m)[-3000:])
        raise
    finally:
        # the router stops on SIGINT (its KeyboardInterrupt path), a
        # submitting CLI kills its job on SIGTERM
        for name, sig in (("cli router", signal.SIGINT),
                          ("holder", signal.SIGTERM),
                          ("cli submit", signal.SIGTERM)):
            proc = procs.get(name)
            if proc is not None and proc.poll() is None:
                proc.send_signal(sig)
        rcs = {}
        for name, proc in procs.items():
            try:
                rcs[name] = proc.wait(timeout=120)
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, signal.SIGKILL)
                rcs[name] = proc.wait(timeout=30)
    mark("shut down")
    statuses = {}
    for name, d in (("cli submit", app_dir),
                    ("holder", glob.glob(os.path.join(
                        root, "hold", "application_*"))[0])):
        with open(os.path.join(d, C.AM_STATUS_FILE)) as f:
            statuses[name] = json.load(f)["status"]
    out.update(want=want, burst_a=burst_a, burst_b=burst_b,
               burst_b0=burst_b0, marks=marks, before=before, after=after,
               after0=after0, final=final, statuses=statuses,
               replicas=replicas, pairs=pairs, rcs=rcs, held=held,
               first=first, reg1=reg1,
               phase_s=time.monotonic() - t_spawn,
               events=_fleet_events(app_dir))
    return out


def _fleet_checks(job: dict, smi: str) -> dict[str, int]:
    from tony_tpu_torch import constants as C
    from tony_tpu_torch.models.llama import get_config

    cfg = get_config(FLEET_CONFIG)
    app_dir, events = job["app_dir"], job["events"]
    names = [e.type.name for e in events]
    # streams: every one is generate's, whichever replica served it
    for tag in ("burst_a", "burst_b", "burst_b0"):
        for i, r in enumerate(job[tag]["answers"]):
            check(r["tokens"] == job["want"][i],
                  f"fleet: {tag} request {i}: {r['tokens']} != generate "
                  f"{job['want'][i]}")
    # the event record, in order
    decisions = _of(events, "AUTOSCALE_DECISION")
    first = decisions[0]
    started1 = _of(events, "TASK_STARTED", task_type="serving",
                   task_index=1)
    check(started1 and events.index(first) < events.index(started1[0])
          < events.index(_of(events, "SERVING_ENDPOINT_REGISTERED",
                             task_index=1)[0]),
          f"fleet: scale-up -> serving:1 launched -> registered: {names}")
    queued = [d for d in decisions if d.payload.arbiter_action == "queue"]
    check(queued and queued[0].payload.from_replicas == 2
          and events.index(queued[0]) > events.index(started1[0]),
          f"fleet: no queued ask at 2 replicas: "
          f"{[vars(d.payload) for d in decisions]}")
    check(not [d for d in decisions[1:]
               if d.payload.arbiter_action == "admit"]
          and not _of(events, "TASK_STARTED", task_type="serving",
                      task_index=2),
          f"fleet: a third replica was admitted: "
          f"{[vars(d.payload) for d in decisions]}")
    # the queue-depth alert fired during burst A and resolved as its
    # queue drained, before burst B began
    fired = _of(events, "ALERT_FIRING", rule_id="serve.queue_depth_burn")
    resolved = _of(events, "ALERT_RESOLVED",
                   rule_id="serve.queue_depth_burn")
    a, b = job["burst_a"], job["burst_b"]
    check(fired and resolved
          and a["start_ms"] <= fired[0].timestamp <= a["end_ms"]
          and any(fired[0].timestamp < r.timestamp <= b["start_ms"]
                  and r.payload.key == fired[0].payload.key
                  for r in resolved),
          f"fleet: the queue-depth alert's record "
          f"{[(e.type.name, e.timestamp, e.payload.key)
              for e in fired + resolved]}"
          f" against burst A {a['start_ms']:.0f}-{a['end_ms']:.0f}, burst B "
          f"from {b['start_ms']:.0f}")
    # spread: both replicas served burst B
    served = {i: job["after"][i]["requests_finished"]
              - job["before"][i]["requests_finished"]
              for i in job["replicas"]}
    check(min(served.values()) >= 1 and sum(served.values())
          == FLEET_REQUESTS,
          f"fleet: burst B served per replica {served}")
    served0 = {i: job["after0"][i]["requests_finished"]
               - job["after"][i]["requests_finished"]
               for i in job["replicas"]}
    check(sum(served0.values()) == FLEET_REQUESTS,
          f"fleet: burst B at gap 0 served per replica {served0}")
    # the CLI verbs
    rc, text, err = job["cli"]["alerts"]
    check(rc == 0 and "serve.queue_depth_burn" in text
          and "RESOLVED" in text and "FIRING" in text,
          f"fleet: `cli alerts` exited {rc}: {text[-2000:]}{err[-1000:]}")
    app_id = os.path.basename(app_dir)
    rc, text, err = job["cli"]["top"]
    row = next((line for line in text.splitlines()
                if line.startswith(app_id[:36])), "")
    check(rc == 0 and row.split()[3:6] == ["RUNNING", "2", "2"],
          f"fleet: `cli top` exited {rc}, row {row!r}: {text[-2000:]}"
          f"{err[-1000:]}")
    rc, text, err = job["cli"]["arbiter"]
    check(rc == 0 and json.loads(text)["action"] == "queue",
          f"fleet: `cli arbiter` exited {rc}: {text[-2000:]}{err[-1000:]}")
    rc, text, err = job["cli"]["router"]
    check(rc == 0 and sum(" UP " in line for line in text.splitlines())
          == 2, f"fleet: `cli router --status` exited {rc}: {text}{err}")
    # shutdown: the router stopped cleanly, each CLI exited as the
    # submitter does on SIGTERM (cluster_submitter.py: 130) with its job
    # KILLED, and the router's and both replicas' ports closed
    check(job["rcs"] == {"cli submit": 130, "cli router": 0, "holder": 130}
          and job["statuses"] == {"cli submit": "KILLED",
                                  "holder": "KILLED"},
          f"fleet: exits {job['rcs']}, final statuses {job['statuses']}")
    for url in [job["router"], *job["replicas"].values()]:
        check(not _listening(int(url.rsplit(":", 1)[1])),
              f"fleet: {url} still listens after SIGTERM")
    # each replica's own launches against its own prefill and step counts
    launches: dict[str, int] = {}
    for i in job["replicas"]:
        stats = job["final"][i]
        with open(os.path.join(app_dir, C.CONTAINERS_DIR_NAME,
                               f"serving_{i}_s0", "stderr")) as f:
            got = _am_launches(f.read(), f"fleet serving:{i}")
        admissions, steps = stats["admissions"], stats["decode_steps"]
        want = {"flash_fwd": cfg.n_layers * admissions,
                "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                "rmsnorm_fwd": (2 * cfg.n_layers + 1)
                * (admissions + steps), "int8_matmul": 0,
                "decode_attention": _k6_launches(cfg, steps)}
        check(got == want, f"fleet: serving:{i} launched {got}, its "
                           f"{admissions} admissions and {steps} decode "
                           f"steps want {want}")
        log(f"fleet: serving:{i} at {job['replicas'][i]}: "
            f"{stats['requests_finished']} requests, {admissions} "
            f"admissions, {steps} decode steps, its own count of its "
            f"launches {got}; burst B sent it {served[i]}")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
    # the numbers
    with open(os.path.join(glob.glob(os.path.join(
            app_dir, C.HISTORY_DIR_NAME, "*"))[0], C.METRICS_FILE)) as f:
        depth = json.load(f).get("serving:0", {}).get(
            "SERVING_QUEUE_DEPTH", [])
    crossed = next((ts for ts, v in depth if v > FLEET_QUEUE_SLO), None)
    reg0 = _of(events, "SERVING_ENDPOINT_REGISTERED", task_index=0)[0]
    check(crossed is not None, f"fleet: serving:0's queue never crossed "
                               f"{FLEET_QUEUE_SLO}: {depth}")
    ttft = {tag: [r["first_s"] * 1e3 for r in job[tag]["answers"]]
            for tag in ("burst_a", "burst_b", "burst_b0")}
    added = [(r - d) * 1e3 for d, r in job["pairs"]]
    log(f"fleet: {FLEET_CONFIG} {str(cfg.dtype).replace('torch.', '')} on "
        f"{FLEET_SLOTS}-slot replicas through "
        f"`cli router`: {3 * FLEET_REQUESTS} streams (prompt "
        f"{FLEET_PROMPT}, {FLEET_NEW} new) equal generate; events "
        f"{[n for n in names if n not in ('TASK_FINISHED',)]}; decisions "
        f"{[(d.payload.direction, d.payload.from_replicas,
             d.payload.to_replicas, d.payload.arbiter_action)
            for d in decisions]}; "
        f"the holder job {job['held']['app_id']} at "
        f"{job['held']['requested_chips']} chips {job['holder_after_s']:.2f}"
        f" s after the scale-up; {smi}")
    log(f"fleet: burst A {a['wall']:.2f} s, TTFT p50 "
        f"{_pct(ttft['burst_a'], 0.5):.1f} ms p95 "
        f"{_pct(ttft['burst_a'], 0.95):.1f} ms; burst B "
        f"{b['wall']:.2f} s, TTFT p50 {_pct(ttft['burst_b'], 0.5):.1f}"
        f" ms p95 {_pct(ttft['burst_b'], 0.95):.1f} ms; {smi}")
    b0 = job["burst_b0"]
    log(f"fleet: burst B with no gap between requests {b0['wall']:.2f} s, "
        f"TTFT p50 {_pct(ttft['burst_b0'], 0.5):.1f} ms p95 "
        f"{_pct(ttft['burst_b0'], 0.95):.1f} ms; served per replica "
        f"{served0}, against {served} {FLEET_GAP_S * 1e3:.0f} ms apart; "
        f"{smi}")
    log(f"fleet: scale-up decision -> serving:1 registered "
        f"{(job['reg1'].timestamp - job['first'].timestamp) / 1e3:.2f} s; "
        f"queue crossing {FLEET_QUEUE_SLO} -> ALERT_FIRING "
        f"{fired[0].timestamp - crossed} ms; the router's added wall per "
        f"request (routed - direct to the replica it went to, "
        f"{FLEET_PAIRS} pairs of prompt 16, 1 new) median "
        f"{_pct(added, 0.5):.2f} ms, p25 {_pct(added, 0.25):.2f} ms, p75 "
        f"{_pct(added, 0.75):.2f} ms, each "
        f"{[round(a, 2) for a in added]}; CLI spawn -> serving:0 "
        f"registered {(reg0.timestamp - job['spawn_ms']) / 1e3:.2f} s; "
        f"the phase "
        f"{job['phase_s']:.1f} s; exits {job['rcs']}; {smi}")
    log(f"fleet: seconds from the CLI's spawn: {job['marks']}")
    return launches


def phase_fleet(smi: str) -> dict[str, int]:
    """The served model through `cli router`, scaled by the AM's
    autoscaler through the arbiter, with no module of tony_tpu
    importable. Returns the replicas' own counts of their launches."""
    import torch

    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="chip-smoke-fleet-")
    try:
        cache, env = _am_tree(root)
        job = _fleet_job(root, env, cache, smi)
        return _fleet_checks(job, smi)
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 18: the history portal and the workflow adapter
# ---------------------------------------------------------------------------

PORTAL_TRAIN_STEPS = 16
PORTAL_MOVER_MS = 1000
PORTAL_JOB_S = 300.0
PORTAL_FAIL_EXIT = 3
PORTAL_PROFILE_STEPS = 2
# a workflow engine's step: the props file in, `run()`'s return code out
WORKFLOW_STEP = """import json, sys
from tony_tpu_torch.workflow import TonyWorkflowJob
with open(sys.argv[1]) as f:
    props = json.load(f)
rc = TonyWorkflowJob(props, working_dir=sys.argv[2]).run()
print(f"WORKFLOW_RC {rc}", flush=True)
sys.exit(rc)
"""
STEP_LINE = re.compile(r"step (\d+) loss ")
MFU_LINE = re.compile(r"^step (\d+) TRAIN_MFU_PCT (\S+)$")


def _workflow_start(root: str, env: dict, tag: str, props: dict):
    """The step script in its own session, its output in
    `<root>/<tag>.wf.log`. Returns (process, spawn time)."""
    wd = os.path.join(root, f"{tag}.wd")
    os.makedirs(wd)
    props_path = os.path.join(root, f"{tag}.props.json")
    with open(props_path, "w") as f:
        json.dump({k: str(v) for k, v in props.items()}, f)
    step = os.path.join(root, "workflow_step.py")
    if not os.path.exists(step):
        with open(step, "w") as f:
            f.write(WORKFLOW_STEP)
    t_spawn = time.time()
    with open(os.path.join(root, f"{tag}.wf.log"), "w") as out:
        proc = subprocess.Popen(
            [sys.executable, step, props_path, wd], cwd=root, env=env,
            stdout=out, stderr=subprocess.STDOUT, start_new_session=True)
    return proc, t_spawn


def _workflow_rc(root: str, tag: str, proc) -> int:
    """`run()`'s return value as the step script printed it."""
    with open(os.path.join(root, f"{tag}.wf.log")) as f:
        said = f.read()
    rcs = re.findall(r"^WORKFLOW_RC (-?\d+)$", said, re.M)
    check(len(rcs) == 1 and int(rcs[0]) == proc.returncode,
          f"portal: {tag}: the step exited {proc.returncode} and said:"
          f"\n{said[-3000:]}")
    return int(rcs[0])


def _workflow_props(cache: str, workdir: str, stage: str,
                    intermediate: str) -> dict:
    """The tony.* keys of the cli phase's job, staged and with its
    history where the caller says."""
    return {**{k: v for k, v in AM_CONF.items()
               if k != "tony.am.stop-poll-timeout-ms"},
            "tony.worker.instances": 1,
            "tony.application.framework": "pytorch",
            "tony.cluster.workdir": workdir,
            "tony.executor.jax-cache-dir": cache,
            "tony.staging.location": stage,
            "tony.history.intermediate": intermediate}


class _Portal:
    """`python -m tony_tpu_torch.portal` in its own session."""

    def __init__(self, root: str, env: dict, hist: str, stage: str):
        conf = _write_conf(os.path.join(root, "portal.json"), {
            "tony.history.mover-interval-ms": PORTAL_MOVER_MS,
            # a day: every job of the run is spared, the purger still
            # walks the finished tree each second
            "tony.history.retention-sec": 24 * 3600,
            "tony.history.purger-interval-ms": PORTAL_MOVER_MS,
            "tony.fleet.publish-interval-ms": PORTAL_MOVER_MS})
        self.out = os.path.join(root, "portal.out")
        self.err = os.path.join(root, "portal.err")
        t0 = time.monotonic()
        with open(self.out, "w") as out, open(self.err, "w") as err:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "tony_tpu_torch.portal", "--port",
                 "0", "--history-location", hist, "--history-store",
                 stage, "--conf", conf], cwd=root,
                env=dict(env, PYTHONUNBUFFERED="1"), stdout=out,
                stderr=err, start_new_session=True)
        self.url = ""
        while not self.url and time.monotonic() - t0 < 120:
            check(self.proc.poll() is None,
                  f"portal: the daemon exited {self.proc.poll()}")
            with open(self.out) as f:
                found = re.findall(r"^tony-tpu portal: (http://\S+)/$",
                                   f.read(), re.M)
            self.url = found[0] if found else ""
            time.sleep(0.05)
        check(self.url, "portal: no banner within 120 s")
        self.up_s = time.monotonic() - t0

    def get(self, path: str) -> tuple[int, bytes]:
        code, _, body = _http(self.url + path, timeout=30)
        return code, body

    def json(self, path: str):
        code, body = self.get(path)
        check(code == 200, f"portal: GET {path} answered {code}: "
                           f"{body[:500]!r}")
        return json.loads(body)

    def job(self, app_id: str) -> dict:
        jobs = {j["application_id"]: j for j in self.json("/api/jobs")}
        return jobs.get(app_id, {})

    def tail(self) -> str:
        with open(self.err) as f:
            return f.read()[-3000:]

    def stop(self) -> int:
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGINT)
        try:
            return self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.wait(timeout=30)
            return -9


def _portal_failing_job(root: str, env: dict, cache: str, stage: str
                        ) -> str:
    """(1) A failing job through the workflow adapter, its history kept
    off the portal's tree: it reaches the portal only through the
    store. Returns its app id."""
    script = os.path.join(root, "exit3.py")
    with open(script, "w") as f:
        f.write(f"import sys\nsys.exit({PORTAL_FAIL_EXIT})\n")
    workdir = os.path.join(root, "fail.apps")
    props = {**_workflow_props(cache, workdir, stage,
                               os.path.join(root, "offhost-history")),
             "executes": script}
    proc, t_spawn = _workflow_start(root, env, "fail", props)
    try:
        proc.wait(timeout=PORTAL_JOB_S)
    except subprocess.TimeoutExpired:
        raise SmokeFailure(f"portal: fail: the workflow ran past "
                           f"{PORTAL_JOB_S:.0f} s")
    rc = _workflow_rc(root, "fail", proc)
    check(rc == 1, f"portal: fail: run() returned {rc}, want 1")
    [app_dir] = glob.glob(os.path.join(workdir, "application_*"))
    log(f"portal: fail: `run()` of a job whose worker exits "
        f"{PORTAL_FAIL_EXIT} returned 1 in {time.time() - t_spawn:.2f} s; "
        f"its history under {root}/offhost-history, published to the "
        f"store")
    return os.path.basename(app_dir)


def _portal_fetched(portal: "_Portal", app_id: str) -> None:
    """(2) The fetcher's first pass brought the failing job in."""
    deadline = time.monotonic() + 10 * PORTAL_MOVER_MS / 1000.0
    job = portal.job(app_id)
    while job.get("status") != "FAILED" and time.monotonic() < deadline:
        time.sleep(0.1)
        job = portal.job(app_id)
    check(job.get("status") == "FAILED",
          f"portal: the fetched job {app_id} lists as {job}")
    diag = portal.json(f"/api/jobs/{app_id}/diagnostics")
    first = diag.get("first_failure") or {}
    check(first.get("exit_code") == PORTAL_FAIL_EXIT,
          f"portal: {app_id}'s diagnostics name {first}")
    log(f"portal: the fetcher's first pass brought {app_id} in from the "
        f"store: /api/jobs lists it FAILED, its diagnostics name "
        f"{first.get('task_id')} exit {first.get('exit_code')} "
        f"({first.get('reason')})")


def _portal_live(portal: "_Portal", proc, t_spawn: float) -> dict:
    """(3) While the job runs: the pages, the live log route, skew,
    alerts and the profile POST, all through the portal."""
    deadline = time.monotonic() + PORTAL_JOB_S
    app_id = ""
    while not app_id and time.monotonic() < deadline:
        check(proc.poll() is None, f"portal: train: the workflow exited "
                                   f"{proc.poll()} before the job ran")
        running = [j["application_id"] for j in portal.json("/api/jobs")
                   if j["status"] == "RUNNING"]
        app_id = running[0] if running else ""
        time.sleep(0.05)
    check(app_id, "portal: train: no RUNNING job within the limit")
    # follow worker:0's stderr from its start until a step line shows
    route = f"/api/jobs/{app_id}/logs/worker:0?stream=stderr"
    offset, text, chunks = 0, "", 0
    while not STEP_LINE.search(text):
        check(time.monotonic() < deadline and proc.poll() is None,
              f"portal: train: no step line through {route} "
              f"({chunks} chunks, {len(text)} bytes)")
        code, body = portal.get(f"{route}&offset={offset}")
        if code == 200:
            chunk = json.loads(body)
            check(chunk["next_offset"] >= offset,
                  f"portal: train: {route} went back: {chunk}")
            text += chunk.get("data", "")
            offset = chunk["next_offset"]
            chunks += 1
        time.sleep(0.1)
    seen_s = time.time() - t_spawn
    index_code, index = portal.get("/")
    check(index_code == 200 and app_id.encode() in index
          and b"RUNNING" in index,
          f"portal: train: / answered {index_code} without {app_id} "
          f"RUNNING")
    check(portal.job(app_id).get("status") == "RUNNING",
          f"portal: train: /api/jobs lists {portal.job(app_id)}")
    page_code, _ = portal.get(f"/jobs/{app_id}")
    check(page_code == 200, f"portal: train: /jobs/{app_id} answered "
                            f"{page_code}")
    time.sleep(1.0)
    chunk = portal.json(f"{route}&offset={offset}")
    check(chunk["next_offset"] > offset and chunk.get("data"),
          f"portal: train: the next poll of {route} at {offset} gave "
          f"{ {k: v for k, v in chunk.items() if k != 'data'} }")
    skew = portal.json(f"/api/jobs/{app_id}/skew")
    alerts = portal.json(f"/api/jobs/{app_id}/alerts")
    check(skew.get("source") == "live" and alerts.get("source") == "live",
          f"portal: train: skew from {skew.get('source')}, alerts from "
          f"{alerts.get('source')}: want both live from the AM")
    rules = alerts.get("rules", [])
    check("train.mfu_floor" in rules, f"portal: train: rules {rules}")
    t0 = time.monotonic()
    code, _, body = _http(
        f"{portal.url}/api/jobs/{app_id}/profile",
        data=json.dumps({"task_id": "worker:0",
                         "num_steps": PORTAL_PROFILE_STEPS}).encode(),
        headers={"Content-Type": "application/json"}, timeout=30)
    post_ms = (time.monotonic() - t0) * 1e3
    ask = json.loads(body)
    check(code == 200 and not ask.get("error") and ask.get("request_id"),
          f"portal: train: the profile POST answered {code}: {ask}")
    check(proc.poll() is None, "portal: train: the job ended before the "
                               "live probes did: raise its steps")
    log(f"portal: train: while {app_id} ran: / and /api/jobs showed it "
        f"RUNNING, /jobs/{app_id} 200; worker:0's stderr through the "
        f"portal's live route in {chunks} chunks to {offset} bytes, the "
        f"next poll {offset} -> {chunk['next_offset']}; skew and alerts "
        f"live from the AM ({len(skew.get('signals', {}) or {})} skew "
        f"signals, rules {rules}); POST profile -> "
        f"{ask.get('request_id')} ({ask.get('task_id')}, "
        f"{ask.get('num_steps')} steps) in {post_ms:.1f} ms")
    return {"app_id": app_id, "seen_s": seen_s, "post_ms": post_ms,
            "request_id": ask["request_id"]}


def _portal_train(root: str, env: dict, cache: str, stage: str, hist: str,
                  portal: "_Portal", smi: str) -> dict[str, int]:
    """(3) The full-width training job through the workflow adapter, its
    history under the portal's own tree."""
    from tony_tpu_torch import constants as C
    from tony_tpu_torch.models.llama import get_config
    from tony_tpu_torch.portal.mover import finished_subdir

    workdir = os.path.join(root, "train.apps")
    props = {**_workflow_props(cache, workdir, stage,
                               os.path.join(hist, "intermediate")),
             "tony.worker.tpus": 1,
             "tony.fleet.publish-interval-ms": PORTAL_MOVER_MS,
             # a floor no healthy step comes near: the AM then runs its
             # alert engine, which the portal's alerts route reads live
             "tony.alerts.mfu-floor-pct": 1,
             "executes": f"{sys.executable} -m tony_tpu_torch.train",
             "task_params": f"--config {TRAIN_CONFIG} --batch-size "
                            f"{TRAIN_BATCH} --seq-len {TRAIN_SEQ} --steps "
                            f"{PORTAL_TRAIN_STEPS} --log-every 1"}
    proc, t_spawn = _workflow_start(root, env, "train", props)
    live = _portal_live(portal, proc, t_spawn)
    app_id = live["app_id"]
    app_dir = os.path.join(workdir, app_id)
    moved_at, deadline = 0.0, time.monotonic() + PORTAL_JOB_S
    pattern = os.path.join(hist, "finished", "*", "*", "*", app_id)
    while proc.poll() is None or not moved_at:
        check(time.monotonic() < deadline,
              f"portal: train: the workflow or the mover ran past "
              f"{PORTAL_JOB_S:.0f} s")
        if not moved_at and glob.glob(pattern):
            moved_at = time.time()
        time.sleep(0.02)
    rc = _workflow_rc(root, "train", proc)
    stderr = _am_task_log(app_dir, "worker_0", "stderr")
    check(rc == 0, f"portal: train: run() returned {rc}; the task's "
                   f"stderr:\n{stderr[-3000:]}")
    with open(os.path.join(app_dir, C.AM_STATUS_FILE)) as f:
        completed_ms = json.load(f)["completed"]
    check(glob.glob(pattern) == [os.path.join(finished_subdir(
        os.path.join(hist, "finished"), completed_ms), app_id)],
        f"portal: train: finished dirs {glob.glob(pattern)}")
    job = portal.job(app_id)
    check(job.get("status") == "SUCCEEDED",
          f"portal: train: /api/jobs lists {job} after the move")
    # the record, the launches
    record = portal.json(f"/api/jobs/{app_id}/events")
    events = [e["type"] for e in record]
    captured = [e["payload"] for e in record
                if e["type"] == "PROFILE_CAPTURED"]
    check([e for e in events if e not in ("TASK_FINISHED",
                                          "PROFILE_CAPTURED")]
          == TRAIN_JOB_EVENTS,
          f"portal: train: events {events}, want {TRAIN_JOB_EVENTS} with "
          f"TASK_FINISHED and PROFILE_CAPTURED left out")
    check([c.get("request_id") for c in captured] == [live["request_id"]]
          and captured[0].get("num_steps") == PORTAL_PROFILE_STEPS,
          f"portal: train: PROFILE_CAPTURED {captured}")
    launched = _am_launches(stderr, "portal train")
    per_step = _step_launches(get_config(TRAIN_CONFIG).n_layers)
    want = {k: PORTAL_TRAIN_STEPS * v for k, v in per_step.items()}
    check({k: launched.get(k) for k in want} == want,
          f"portal: train: the trainer launched {launched}, want {want}")
    check("nvcc compiled" not in stderr,
          "portal: train: the task compiled a kernel the cache held")
    # the gauges through the portal against the trainer's own log
    series = portal.json(f"/api/jobs/{app_id}/metrics").get("worker:0", {})
    duty = [v for _, v in series.get("TPU_UTILIZATION", [])]
    check(duty and max(duty) >= 50.0,
          f"portal: train: TPU_UTILIZATION {duty}: none >= 50")
    logged = {}
    for m in _log_messages(stderr):
        hit = MFU_LINE.match(m)
        if hit:
            logged[int(hit.group(1))] = float(hit.group(2))
    mfu = [v for _, v in series.get("TRAIN_MFU_PCT", [])]
    check(len(mfu) >= 3 and set(mfu) <= set(logged.values()),
          f"portal: train: TRAIN_MFU_PCT {mfu} against the trainer's "
          f"logged {logged}")
    goodput = portal.json(f"/api/jobs/{app_id}/goodput")
    task_mfu = (goodput.get("tasks", {}).get("worker:0") or {}).get(
        "mfu_pct")
    check(task_mfu in set(logged.values()),
          f"portal: train: goodput's mfu_pct {task_mfu}, logged "
          f"{sorted(logged.values())}")
    code, page = portal.get(f"/config/{app_id}")
    conf = portal.json(f"/api/jobs/{app_id}/config")
    missing = [k for k, v in props.items() if k.startswith("tony.") and (
        str(conf.get(k)) != str(v)
        or f"<td>{html.escape(k)}</td><td>{html.escape(str(conf[k]))}"
           f"</td>" not in page.decode())]
    check(code == 200 and not missing,
          f"portal: train: /config/{app_id} ({code}) lacks {missing}")
    fleet = {j["app_id"]: j for j in portal.json("/api/fleet")["jobs"]}
    from tony_tpu_torch.observability.fleet import chips_of
    mine = fleet.get(app_id, {})
    check(mine.get("state") == "SUCCEEDED" and chips_of(mine) == 1,
          f"portal: train: /api/fleet lists {mine}")
    code, text = portal.get("/metrics")
    from tony_tpu_torch.observability.prometheus import parse
    try:
        samples = parse(text.decode())
    except ValueError as e:
        raise SmokeFailure(f"portal: /metrics: {e}")
    check(code == 200 and samples, f"portal: /metrics answered {code}")
    spans = {sp["name"]: sp
             for sp in portal.json(f"/api/jobs/{app_id}/spans")}
    app_span, task = spans["application"], spans["task:worker:0"]
    lag = moved_at - completed_ms / 1000.0
    mfu_sorted = sorted(mfu)
    log(f"portal: train: {TRAIN_CONFIG} B{TRAIN_BATCH} x S{TRAIN_SEQ}, "
        f"{PORTAL_TRAIN_STEPS} steps through `TonyWorkflowJob.run()`: 0; "
        f"served SUCCEEDED from {os.path.dirname(glob.glob(pattern)[0])}; "
        f"events {events}; the trainer's own count of its launches "
        f"{launched} (= {PORTAL_TRAIN_STEPS} x the train phase's step); "
        f"TPU_UTILIZATION max {max(duty)} of {len(duty)} points; "
        f"TRAIN_MFU_PCT {len(mfu)} points, each one the trainer logged, "
        f"min {mfu_sorted[0]} median {mfu_sorted[len(mfu) // 2]} max "
        f"{mfu_sorted[-1]}; goodput mfu_pct {task_mfu}; /config shows "
        f"all {sum(k.startswith('tony.') for k in props)} tony.* props; "
        f"/api/fleet {mine['state']} at 1 chip; /metrics {len(samples)} "
        f"samples; {smi}")
    log(f"portal: train: workflow spawn -> AM start "
        f"{app_span['start_ms'] - 1000 * t_spawn:.0f} ms, AM start -> "
        f"first container launch "
        f"{task['start_ms'] - app_span['start_ms']} ms, workflow spawn -> "
        f"first step line through the portal {live['seen_s']:.2f} s, the "
        f"profile POST's round trip {live['post_ms']:.1f} ms, the AM's "
        f"verdict -> the job dir in finished/ {lag * 1e3:.0f} ms (mover "
        f"every {PORTAL_MOVER_MS} ms); {smi}")
    return {k: launched.get(k, 0) for k in per_step}


def phase_portal(smi: str) -> dict[str, int]:
    """The workflow adapter and `python -m tony_tpu_torch.portal` around a
    failing job and a full-width training job, with no module of tony_tpu
    importable. Returns the trainer's own count of its launches."""
    import torch

    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="chip-smoke-portal-")
    t0 = time.monotonic()
    portal = None
    try:
        cache, env = _am_tree(root)
        stage, hist = os.path.join(root, "stage"), os.path.join(root, "hist")
        failed = _portal_failing_job(root, env, cache, stage)
        portal = _Portal(root, env, hist, stage)
        log(f"portal: up at {portal.url} in {portal.up_s:.2f} s")
        _portal_fetched(portal, failed)
        launched = _portal_train(root, env, cache, stage, hist, portal, smi)
        rc = portal.stop()
        check(rc == 0, f"portal: SIGINT: the daemon exited {rc}")
        log(f"portal: SIGINT: the daemon exited 0; the phase "
            f"{time.monotonic() - t0:.1f} s; {smi}")
        return launched
    except SmokeFailure as e:
        tails = [f"the portal's stderr:\n{portal.tail()}"] if portal else []
        for am_err in glob.glob(os.path.join(root, "*.apps", "*",
                                             "am.stderr")):
            with open(am_err) as f:
                tails.append(f"{am_err}:\n{f.read()[-3000:]}")
        for wf in glob.glob(os.path.join(root, "*.wf.log")):
            with open(wf) as f:
                tails.append(f"{wf}:\n{f.read()[-2000:]}")
        raise SmokeFailure("\n".join([str(e)] + tails))
    finally:
        if portal is not None and portal.proc.poll() is None:
            os.killpg(portal.proc.pid, signal.SIGKILL)
            portal.proc.wait(timeout=30)
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 19: long-context training, the train -> serve handoff, the goodput
# report
# ---------------------------------------------------------------------------

# pretrain_long on the train phase's model at S LONG_SEQ, rescaled RoPE
LONG_SEQ = 32768
LONG_ROPE_SCALING = 8
LONG_STEPS = 4
LONG_ARGV = ["--config", TRAIN_CONFIG, "--seq-len", str(LONG_SEQ),
             "--batch-size", "1", "--rope-scaling", str(LONG_ROPE_SCALING),
             "--steps", str(LONG_STEPS)]
# its attention: (B, H, Hkv, S, D), for K1-K3 and the ring and Ulysses
LONG_SHAPE = (1, 16, 8, LONG_SEQ, 128)
# the NCCL world of one it trains on, sp of 1
LONG_MESH = {"TPU_MESH_SHAPE": "1,1", "TPU_MESH_AXES": "fsdp,sp"}
# the step of the plain versions beside the kernels': its depth (all 16
# layers' plain attention at S 32768 would take tens of seconds), and the
# limits: the loss at bf16's tolerance, each gradient by norm
LONG_PLAIN_LAYERS = 2
LONG_LOSS_TOL = TOL["bfloat16"]
LONG_GRAD_TOL = NORM_TOL
# the first loss's distance from ln(vocab) (random weights)
LONG_LOSS0_TOL = 0.5
# the serving submitter's limit; its engine runs at generate's shapes (one
# slot, a budget of prompt + new tokens: K5 plans its split of K by the row
# count, so 4 slots would sum a decode step's products otherwise than
# generate's one row does)
SUBMIT_JOB_S = 300.0
# K1-K3 at LONG_SHAPE, for the kernels line
LONG_CASES: dict = {}


def _long_kernels(peaks) -> None:
    """(a): K1-K3 at LONG_SHAPE against `blockwise_forward` /
    `blockwise_backward`, twice and bit for bit, timed beside the plain
    versions and SDPA, kept in LONG_CASES."""
    import torch

    b, h, hk, s, d = LONG_SHAPE
    dq, dkv, fwd = _flash_bwd_case(b, h, hk, s, d, True, "bfloat16", "bshd",
                                   peaks, timed_case=True)
    for name, r in (("flash_fwd", fwd), ("flash_bwd_dq", dq),
                    ("flash_bwd_dkv", dkv)):
        r["summary"] = False
        _report(name, r)
        _hold_all(name, [r])
        LONG_CASES[name] = r
    torch.cuda.empty_cache()


@contextlib.contextmanager
def _plain_kernels():
    """The flash forward, its backward and the RMSNorm forward take their
    plain versions on the card too while inside, for a step of the plain
    versions on the same weights and batch as the kernels' step."""
    from tony_tpu_torch.ops import attention, rmsnorm

    def fwd(q, k, v, causal, sm_scale):
        out, lse = attention.blockwise_forward(q, k, v, causal, sm_scale)
        return out.transpose(1, 2).contiguous(), lse

    saved = (attention._flash_fwd_cuda_bshd, attention.flash_backward,
             rmsnorm.rms_norm_cuda)
    attention._flash_fwd_cuda_bshd = fwd
    attention.flash_backward = attention.blockwise_backward
    rmsnorm.rms_norm_cuda = rmsnorm.rms_norm_reference
    try:
        yield
    finally:
        (attention._flash_fwd_cuda_bshd, attention.flash_backward,
         rmsnorm.rms_norm_cuda) = saved


@contextlib.contextmanager
def _counted_trainer(record: dict):
    """Every Trainer set up inside has its step wrapped: counts set to 0
    just before a step and read just after, the step's wall (from a
    drained device to a drained device), its loss. The Trainer lands in
    record["trainer"], the steps in record["steps"]."""
    import torch
    import torch.distributed as dist

    from tony_tpu_torch.ops import cuda_lib
    from tony_tpu_torch.train.trainer import Trainer

    setup = Trainer.setup

    def counted_setup(self):
        setup(self)
        record["trainer"] = self
        record["backend"] = dist.get_backend() if dist.is_initialized() \
            else None
        step_fn = self.train_step

        def counted_step(params, opt_state, batch):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            cuda_lib.reset_launches()
            out = step_fn(params, opt_state, batch)
            torch.cuda.synchronize()
            record["steps"].append({
                "s": time.monotonic() - t0, "loss": out[2],
                "launches": dict(cuda_lib.launches())})
            return out
        self.train_step = counted_step

    Trainer.setup = counted_setup
    try:
        yield
    finally:
        Trainer.setup = setup


def _long_plain_step(cfg, tokens) -> None:
    """Step 1's loss and gradients of the kernels against the plain
    versions on the same weights (seeded) and batch, at LONG_PLAIN_LAYERS
    layers of `cfg`."""
    import dataclasses

    import torch

    from tony_tpu_torch.models.llama import llama_init, llama_loss
    from tony_tpu_torch.ops import cuda_lib
    from tony_tpu_torch.train.checkpoint import flatten_with_paths

    cfg = dataclasses.replace(cfg, n_layers=LONG_PLAIN_LAYERS)
    params = llama_init(cfg, torch.Generator(device="cuda").manual_seed(0))
    leaves = flatten_with_paths(params)
    for _, leaf in leaves:
        leaf.requires_grad_(True)
    batch = {"tokens": torch.from_numpy(tokens).to("cuda")}

    def step() -> tuple[float, dict, float, dict]:
        for _, leaf in leaves:
            leaf.grad = None
        torch.cuda.synchronize()
        cuda_lib.reset_launches()
        t0 = time.monotonic()
        loss = llama_loss(params, batch, cfg)
        loss.backward()
        torch.cuda.synchronize()
        return (loss.item(), {path: leaf.grad.clone()
                              for path, leaf in leaves},
                time.monotonic() - t0, dict(cuda_lib.launches()))

    loss, grads, wall, launched = step()
    with _plain_kernels():
        plain_loss, plain_grads, plain_wall, plain_launched = step()
    cuda_lib.reset_launches()
    want = _step_launches(LONG_PLAIN_LAYERS)
    check({k: launched[k] for k in want} == want,
          f"long: the kernels' step launched {launched}, want {want}")
    check(not any(plain_launched.values()),
          f"long: the plain step launched {plain_launched}")
    rel = abs(loss - plain_loss) / abs(plain_loss)
    errs = {path: _grad_norm_err(grads[path], plain_grads[path])
            for path in grads}
    worst = max(errs, key=errs.get)
    log(f"long: step 1 at {LONG_PLAIN_LAYERS} layers, B1 x S{LONG_SEQ}: "
        f"kernels' loss {loss:.6f}, plain versions' {plain_loss:.6f} "
        f"(relative {rel:.2e}, tol {LONG_LOSS_TOL}); worst gradient by "
        f"norm {errs[worst]:.2e} ({'/'.join(worst)}, tol {LONG_GRAD_TOL}); "
        f"wall {wall:.3f} s against the plain {plain_wall:.3f} s")
    check(rel <= LONG_LOSS_TOL, f"long: step 1 loss {loss} against the "
          f"plain versions' {plain_loss}")
    check(errs[worst] <= LONG_GRAD_TOL, f"long: gradient {'/'.join(worst)} "
          f"{errs[worst]:.2e} by norm against the plain versions'")
    del params, leaves, grads, plain_grads
    gc.collect()
    torch.cuda.empty_cache()


def _long_pretrain(smi: str) -> dict[str, int]:
    """(c): `pretrain_long.main(LONG_ARGV)` in this process on an NCCL
    world of one (mesh LONG_MESH), then step 1 against the plain versions.
    Returns its launches."""
    import torch

    from tony_tpu_torch.device import peak_flops
    from tony_tpu_torch.examples import pretrain_long
    from tony_tpu_torch.train.data import synthetic_tokens

    cfg, seq = pretrain_long.long_config(
        pretrain_long.build_arg_parser().parse_args(LONG_ARGV))
    from tony_tpu_torch.models.llama import get_config
    window = get_config(TRAIN_CONFIG).max_seq
    check(seq == LONG_SEQ and cfg.max_seq == LONG_SEQ
          and cfg.rope_orig_max_seq == window
          and cfg.rope_scaling_factor == LONG_ROPE_SCALING,
          f"long: pretrain_long's config {cfg}")
    env = {"WORLD": "1", "RANK": "0",
           "INIT_METHOD": f"tcp://127.0.0.1:{_free_port()}", **LONG_MESH}
    before = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    record: dict = {"steps": []}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    try:
        with _counted_trainer(record), contextlib.redirect_stdout(
                io.StringIO()) as out:
            rc = pretrain_long.main(LONG_ARGV)
    finally:
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    wall = time.monotonic() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    last = out.getvalue().strip().splitlines()[-1]
    mesh = record["trainer"].mesh
    steps = record["steps"]
    losses = [float(s["loss"]) for s in steps]
    log(f"long: pretrain_long {' '.join(LONG_ARGV)} on an NCCL world of "
        f"one, mesh {LONG_MESH}: exit {rc}, last line {last!r}; the "
        f"process group {record['backend']}, the Trainer's mesh "
        f"{None if mesh is None else mesh.mesh_dim_names}; wall "
        f"{wall:.1f} s")
    check(rc == 0 and last == f"final loss {losses[-1]:.4f} "
          f"(seq={LONG_SEQ}, sp_mode=ring)",
          f"long: pretrain_long exited {rc}, printed {last!r}")
    check(record["backend"] == "nccl" and mesh is not None
          and tuple(mesh.mesh_dim_names) == ("fsdp", "sp"),
          f"long: a {record['backend']} group, mesh {mesh}")
    want = _step_launches(cfg.n_layers)
    total = dict.fromkeys(want, 0)
    for i, s in enumerate(steps, 1):
        got = {k: s["launches"][k] for k in want}
        log(f"long: step {i} loss {losses[i - 1]:.4f} wall {s['s']:.4f} s "
            f"launches {got}")
        check(got == want, f"long: step {i} launched {got}, want {want}")
        for k in want:
            total[k] += got[k]
    check(len(steps) == LONG_STEPS, f"long: {len(steps)} steps")
    check(all(math.isfinite(x) for x in losses), f"long: losses {losses}")
    uniform = math.log(cfg.vocab_size)
    check(abs(losses[0] - uniform) <= LONG_LOSS0_TOL,
          f"long: the first loss {losses[0]} is not within "
          f"{LONG_LOSS0_TOL} of ln {cfg.vocab_size} = {uniform:.4f}")
    # steps 2.. (step 1 builds the allocator's pools)
    step_s = sorted(s["s"] for s in steps[1:])[(len(steps) - 1) // 2]
    tok_s = (LONG_SEQ + 1) / step_s
    peak = peak_flops(torch.device("cuda"))
    mfu = 100.0 * tok_s * cfg.flops_per_token(LONG_SEQ) / peak
    log(f"long: {TRAIN_CONFIG} B1 x S{LONG_SEQ}, RoPE rescaled x"
        f"{LONG_ROPE_SCALING} from {window}: median step (steps 2-"
        f"{LONG_STEPS}) {step_s:.4f} s = {tok_s:.1f} tokens/s, MFU "
        f"{mfu:.2f}% of {peak / 1e12:.0f} TFLOP/s (flops_per_token "
        f"{cfg.flops_per_token(LONG_SEQ):.4e}); first loss "
        f"{losses[0]:.4f} (ln {cfg.vocab_size} = {uniform:.4f}); peak "
        f"memory allocated {peak_gib:.2f} GiB; {smi}")
    del mesh, record, steps
    gc.collect()
    torch.cuda.empty_cache()
    tokens = next(synthetic_tokens(1, LONG_SEQ, cfg.vocab_size))["tokens"]
    _long_plain_step(cfg, tokens)
    return total


def _long_checkpoint(root: str, env: dict) -> str:
    """The ckpt phase's kept llama3_1b_proxy checkpoint, else one written
    by one step of `python -m tony_tpu_torch.train`."""
    if KEPT_CKPT.get("dir"):
        log(f"long: serving the ckpt phase's checkpoint {KEPT_CKPT['dir']}")
        return KEPT_CKPT["dir"]
    d = os.path.join(root, "ckpt")
    t0 = time.monotonic()
    out = subprocess.run(
        [sys.executable, "-m", "tony_tpu_torch.train", "--config",
         TRAIN_CONFIG, "--steps", "1", "--batch-size", "1", "--seq-len",
         "128", "--checkpoint-dir", d], cwd=root, env=env,
        capture_output=True, text=True, timeout=600)
    check(out.returncode == 0, f"long: the checkpoint's training run exited "
          f"{out.returncode}: {out.stderr[-3000:]}")
    log(f"long: wrote a {TRAIN_CONFIG} checkpoint by one step of python -m "
        f"tony_tpu_torch.train in {time.monotonic() - t0:.1f} s")
    return d


def _long_generate(ckpt: str) -> list[int]:
    """`generate` on the checkpoint's latest params, int8-quantized as the
    server quantizes them, in this process."""
    import torch

    from tony_tpu_torch.examples.serve_submit import (
        SMOKE_NEW_TOKENS, SMOKE_PROMPT,
    )
    from tony_tpu_torch.models.convert import empty_params
    from tony_tpu_torch.models.generate import generate
    from tony_tpu_torch.models.llama import get_config
    from tony_tpu_torch.models.quant import quantize_params
    from tony_tpu_torch.ops import cuda_lib
    from tony_tpu_torch.train.checkpoint import latest_step, restore_params

    cfg = get_config(TRAIN_CONFIG)
    with torch.inference_mode():
        params = quantize_params(restore_params(
            ckpt, latest_step(ckpt), empty_params(cfg, "cuda")))
        tokens = generate(params, cfg, torch.tensor([SMOKE_PROMPT],
                                                    device="cuda"),
                          SMOKE_NEW_TOKENS)[0].tolist()
    cuda_lib.reset_launches()
    del params
    torch.cuda.empty_cache()
    return tokens


def _long_serve_submit(root: str, env: dict, cache: str, smi: str
                       ) -> tuple[dict[str, int], str]:
    """(d): `python -m tony_tpu_torch.examples.serve_submit --smoke` on a
    llama3_1b_proxy checkpoint, int8, from the copy of `tony_tpu_torch/`
    alone. Returns the server's own count of its launches and the job's
    app dir."""
    from tony_tpu_torch import constants as C
    from tony_tpu_torch.examples.serve_submit import (
        SMOKE_NEW_TOKENS, SMOKE_PROMPT,
    )
    from tony_tpu_torch.models.llama import get_config

    ckpt = _long_checkpoint(root, dict(env, TONY_JAX_CACHE_DIR=cache))
    site = os.path.join(root, "site")
    os.makedirs(site)
    workdir = os.path.join(root, "apps")
    with open(os.path.join(site, C.TONY_SITE_CONF), "w") as f:
        json.dump({**AM_CONF, "tony.cluster.workdir": workdir,
                   "tony.executor.jax-cache-dir": cache,
                   # the server drains in well under a second
                   "tony.task.term-grace-ms": 2000}, f)
    argv = [sys.executable, "-m", "tony_tpu_torch.examples.serve_submit",
            "--config", TRAIN_CONFIG, "--checkpoint-dir", ckpt,
            "--quant", "int8", "--slots", "1", "--token-budget",
            str(len(SMOKE_PROMPT) + SMOKE_NEW_TOKENS), "--smoke"]
    t0 = time.monotonic()
    proc = subprocess.Popen(argv, cwd=root, env=dict(env, TONY_CONF_DIR=site),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=SUBMIT_JOB_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        stdout, stderr = proc.communicate(timeout=30)
        raise SmokeFailure(f"long: serve_submit ran past {SUBMIT_JOB_S:.0f} "
                           f"s: {stdout[-2000:]}{stderr[-3000:]}")
    wall = time.monotonic() - t0
    lines = stdout.strip().splitlines()
    check(proc.returncode == 0 and lines and lines[-1] == "SERVE_SMOKE_OK",
          f"long: serve_submit exited {proc.returncode}: {stdout[-2000:]}"
          f"{stderr[-3000:]}")
    app_id = next(line for line in lines
                  if line.startswith("submitted ")).split()[1].rstrip(";")
    served = json.loads(next(line for line in lines
                             if line.startswith("generated: "))[11:])
    want_tokens = _long_generate(ckpt)
    log(f"long: serve_submit --smoke ({TRAIN_CONFIG}, int8, from {ckpt}): "
        f"exit 0 in {wall:.1f} s; {lines[1]}; served {served}, generate "
        f"{want_tokens}")
    check(served == want_tokens, f"long: served {served} != generate "
                                 f"{want_tokens}")
    app_dir = os.path.join(workdir, app_id)
    with open(os.path.join(app_dir, C.CONTAINERS_DIR_NAME, "serving_0_s0",
                           "stderr")) as f:
        launched = _am_launches(f.read(), "long serve")
    cfg = get_config(TRAIN_CONFIG)
    # one admission (the prompt's prefill), then a decode step of the one
    # slot per new token after the first
    steps = SMOKE_NEW_TOKENS - 1
    want = {"flash_fwd": cfg.n_layers, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0,
            "rmsnorm_fwd": (2 * cfg.n_layers + 1) * (1 + steps),
            "int8_matmul": _k5_launches(cfg, [len(SMOKE_PROMPT)], steps, 1),
            "decode_attention": _k6_launches(cfg, steps)}
    check({k: launched.get(k, 0) for k in want} == want,
          f"long: the server launched {launched}, one admission and "
          f"{steps} decode steps want {want}")
    log(f"long: the server's own count of its launches {launched} (one "
        f"admission, {steps} decode steps); {smi}")
    return {k: launched.get(k, 0) for k in want}, app_dir


def _long_goodput(root: str, env: dict, app_dir: str) -> None:
    """(e): `python -m tony_tpu_torch.tools.goodput_report` on the serving
    job's app dir: the table, and --json equal to the goodput.json found."""
    from tony_tpu_torch import constants as C

    runs = {}
    for flags in ((), ("--json",)):
        out = subprocess.run(
            [sys.executable, "-m", "tony_tpu_torch.tools.goodput_report",
             app_dir, *flags], cwd=root, env=env, capture_output=True,
            text=True, timeout=120)
        check(out.returncode == 0, f"long: goodput_report {flags} exited "
              f"{out.returncode}: {out.stderr[-2000:]}")
        runs[flags] = out.stdout
    found = glob.glob(os.path.join(app_dir, C.HISTORY_DIR_NAME, "*",
                                   C.GOODPUT_FILE))
    check(len(found) == 1, f"long: goodput files {found}")
    with open(found[0]) as f:
        want = json.load(f)
    check(json.loads(runs[("--json",)]) == want,
          f"long: goodput_report --json {runs[('--json',)][:2000]} != "
          f"{found[0]}")
    log(f"long: goodput_report {app_dir}:\n{runs[()].rstrip()}")


def phase_long(smi: str, peaks) -> tuple[dict[str, int], dict[str, int]]:
    """Long-context training at S LONG_SEQ, the serving submitter and the
    goodput report. Returns (pretrain_long's and the server's launches,
    the ring's and Ulysses' chunk launches)."""
    import torch

    torch.cuda.empty_cache()
    t0 = time.monotonic()
    _long_kernels(peaks)
    sp_launches = _parallel_sp(LONG_SHAPE, "long")
    gc.collect()
    torch.cuda.empty_cache()
    launches = _long_pretrain(smi)
    root = tempfile.mkdtemp(prefix="chip-smoke-long-")
    try:
        cache, env = _am_tree(root)
        served, app_dir = _long_serve_submit(root, env, cache, smi)
        _long_goodput(root, env, app_dir)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for k, v in served.items():
        launches[k] = launches.get(k, 0) + v
    log(f"long: the phase {time.monotonic() - t0:.1f} s; {smi}")
    return launches, sp_launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases",
                    default="build,cache,kernels,serve,engine,profile,"
                            "quant,kvcache,train,ckpt,orch,moe,parallel,"
                            "pipeline,spec,vision,executor,am,cli,fleet,"
                            "portal,long",
                    help="comma-separated phases to run")
    opts = ap.parse_args(argv)
    phases = opts.phases.split(",")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; it runs only on the "
              "card", file=sys.stderr)
        return 2
    try:
        import tony_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e}); run it "
              f"from the root of the repository", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; card {name}; "
        f"nvidia-smi: {smi}")
    peaks = card_peaks(name)
    t_start = time.monotonic()
    try:
        kernels: dict[str, dict] = {}
        launches: dict[str, dict[str, int]] = {}
        if "build" in phases:
            phase_build()
        if "cache" in phases:
            phase_cache(smi)
        if "kernels" in phases:
            kernels = phase_kernels(peaks)
        if "serve" in phases:
            launches["serve"] = phase_serve(SERVE_CONFIG)
        if "engine" in phases:
            phase_engine()
        if "profile" in phases:
            phase_profile(SERVE_CONFIG)
        if "quant" in phases:
            launches["quant"] = phase_quant(SERVE_CONFIG)
        if "kvcache" in phases:
            launches["kvcache"] = phase_kvcache(SERVE_CONFIG)
        if "train" in phases:
            launches["train"] = phase_train()
            phase_train_parity()
        if "ckpt" in phases:
            launches["ckpt"] = phase_ckpt(smi, keep="long" in phases)
        if "orch" in phases:
            launches["orch"] = phase_orch(smi)
        if "moe" in phases:
            launches["moe"] = phase_moe()
        if "parallel" in phases:
            launches["parallel"], launches["parallel_sp"] = \
                phase_parallel(smi)
        if "pipeline" in phases:
            launches.update(phase_pipeline(smi, peaks))
        if "spec" in phases:
            launches["spec"] = phase_spec()
        if "vision" in phases:
            launches["vision"] = phase_vision()
        if "executor" in phases:
            launches["executor"] = phase_executor(smi)
        if "am" in phases:
            launches["am"] = phase_am(smi)
        if "cli" in phases:
            launches["cli"] = phase_cli(smi)
        if "fleet" in phases:
            launches["fleet"] = phase_fleet(smi)
        if "portal" in phases:
            launches["portal"] = phase_portal(smi)
        if "long" in phases:
            launches["long"], launches["long_sp"] = phase_long(smi, peaks)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        if KEPT_CKPT:
            shutil.rmtree(KEPT_CKPT["root"], ignore_errors=True)
    from tony_tpu_torch.ops import cuda_lib
    entries = []
    for kname in LONG_CASES:
        kernels.setdefault(kname, LONG_CASES[kname])
    for kname, r in kernels.items():
        k = cuda_lib.KERNELS[kname]
        by_path = {path: counts.get(kname, 0)
                   for path, counts in launches.items()}
        entries.append({
            "name": kname, "route": "cuda",
            "source": f"tony_tpu_torch/csrc/{k.source}",
            "replaces": k.replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "call_ms": r["call_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "library_call": r.get("library_call"), "shape": r["shape"],
            "dtype": r["dtype"]})
        if kname in LONG_CASES and LONG_CASES[kname] is not r:
            # the long phase's shape beside the summary's
            entries[-1]["long"] = {key: LONG_CASES[kname].get(key) for key in (
                "shape", "dtype", "max_abs_err", "norm_err", "ms",
                "call_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "library_call")}
    log(f"chip_smoke: phases {phases} passed in "
        f"{time.monotonic() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
