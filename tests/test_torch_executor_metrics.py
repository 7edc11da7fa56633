"""The port's executor, on the CPU, against the JAX package's: what it
renders, reads and reports.

- Runtimes: `render_framework_env` of both packages on the same cluster
  specs gives equal dicts, and raises the same errors, for every
  framework (chief plus workers, serving, num-slices, a coordinator port,
  a mesh shape).
- Conf: one frozen `tony-final.json` read by both packages gives equal
  values for every key the executor reads; so do the defaults.
- Monitor: one sample sequence (empty intervals, a raising sampler, a GPU
  plane) fed to both `TaskMonitor`s pushes equal snapshots.
- `cuda_metrics` over a stand-in for NVML's C interface: pids matched
  across a process tree and two cards, a tree with no context, a pid
  namespace NVML's pids are not in, NVML that cannot be loaded or hangs.
- Logs: the live tail and the failure diagnostics equal the JAX
  package's on the same container files.
"""

import ctypes
import json
import logging
import os
import subprocess
import sys
import threading
import time

import pytest

from tony_tpu.conf import TonyConfiguration, keys as JK
from tony_tpu.executor import runtimes as jruntimes
from tony_tpu.executor import task_monitor as jmonitor
from tony_tpu.observability import logs as jlogs
from tony_tpu_torch.conf import TonyConfiguration as PortConfiguration
from tony_tpu_torch.conf import keys as K
from tony_tpu_torch.executor import cuda_metrics, runtimes, task_monitor
from tony_tpu_torch.observability import logs


# ---------------------------------------------------------------------------
# runtimes
# ---------------------------------------------------------------------------

SPECS = {
    "workers": {"worker": ["h0:1000", "h1:1001", "h2:1002"]},
    "chief": {"chief": ["c0:900"], "worker": ["h0:1000", "h1:1001"],
              "ps": ["p0:800"]},
    "serving": {"worker": ["h0:1000"], "serving": ["s0:7000", "s1:7001"]},
    "mxnet": {"scheduler": ["sch:500"], "server": ["sv0:600", "sv1:601"],
              "worker": ["h0:1000", "h1:1001"]},
    "no_worker": {"chief": ["c0:900"], "evaluator": ["e0:950"]},
}
CONFS = {
    "plain": {},
    "slices": {"tony.tpu.num-slices": 2},
    "coordinator": {"tony.tpu.coordinator-port": 8476,
                    "tony.tpu.mesh-shape": "2,2", "tony.tpu.mesh-axes":
                    "fsdp,tp", "tony.executor.jax-cache-dir": "/c/kernels"},
}


def _both_confs(values: dict):
    jconf, pconf = TonyConfiguration(), PortConfiguration()
    for k, v in values.items():
        jconf.set(k, v, "test")
        pconf.set(k, v, "test")
    return jconf, pconf


def _render(module, framework, spec, job, index, conf):
    try:
        return ("env", module.render_framework_env(framework, spec, job,
                                                   index, conf))
    except Exception as e:  # noqa: BLE001 — the error is the result
        return ("error", type(e).__name__, str(e))


@pytest.mark.parametrize("framework", ["tensorflow", "pytorch", "mxnet",
                                       "horovod", "jax", "PyTorch", "caffe"])
@pytest.mark.parametrize("spec_name", sorted(SPECS))
@pytest.mark.parametrize("conf_name", sorted(CONFS))
def test_render_framework_env_equals_jax(framework, spec_name, conf_name):
    spec = SPECS[spec_name]
    jconf, pconf = _both_confs(CONFS[conf_name])
    for job, entries in spec.items():
        for index in range(len(entries)):
            want = _render(jruntimes, framework, spec, job, index, jconf)
            got = _render(runtimes, framework, spec, job, index, pconf)
            assert got == want, (job, index)


def test_global_order_equals_jax():
    for spec in SPECS.values():
        assert runtimes.global_task_order(spec) \
            == jruntimes.global_task_order(spec)


# ---------------------------------------------------------------------------
# the frozen conf
# ---------------------------------------------------------------------------

EXECUTOR_KEYS = [
    "APPLICATION_FRAMEWORK", "APPLICATION_TIMEOUT",
    "TASK_HEARTBEAT_INTERVAL_MS", "TASK_METRICS_INTERVAL_MS",
    "TASK_REGISTRATION_TIMEOUT_SEC", "TASK_HB_FAILURE_BUDGET",
    "TASK_TERM_GRACE_MS", "AM_ORPHAN_GRACE_MS", "TASK_GPU_METRICS_ENABLED",
    "GPU_PATH_TO_EXEC", "LOGS_TAIL_BYTES", "LOGS_CHUNK_BYTES",
    "LOGS_DIAGNOSTICS_LINES", "SRC_DIR", "PYTHON_VENV",
    "CONTAINERS_RESOURCES", "LOCALIZATION_CACHE_ENABLED",
    "LOCALIZATION_CACHE_DIR", "CHECKPOINT_KEEP", "TPU_MESH_SHAPE",
    "TPU_MESH_AXES", "TPU_NUM_SLICES", "TPU_COORDINATOR_PORT",
    "EXECUTOR_JAX_CACHE_DIR", "PROFILER_ENABLED", "PROFILER_HZ",
    "PROFILER_MAX_STACKS", "PROFILER_STALL_FACTOR",
    "PROFILER_OVERHEAD_BUDGET_PCT",
]


def _reads(conf, keymod) -> dict:
    """Every value the executor reads, through every getter it uses."""
    out = {}
    keys = [getattr(keymod, n) for n in EXECUTOR_KEYS] + [
        keymod.gpus_key("worker"), keymod.resources_key("worker")]
    for key in keys:
        row = {"str": conf.get_str(key), "strings": conf.get_strings(key),
               "source": conf.source_of(key), "raw": conf.get(key)}
        for getter in ("get_int", "get_float", "get_time_ms", "get_bool"):
            try:
                row[getter] = getattr(conf, getter)(key)
            except (ValueError, TypeError) as e:
                row[getter] = type(e).__name__
        out[key] = row
    return out


def test_executor_keys_are_the_jax_keys():
    for name in EXECUTOR_KEYS:
        assert getattr(K, name) == getattr(JK, name), name
    assert K.gpus_key("w") == JK.gpus_key("w")
    assert K.resources_key("w") == JK.resources_key("w")


def test_frozen_conf_reads_equal_jax(tmp_path):
    conf = TonyConfiguration()
    for k, v in {"tony.application.framework": "pytorch",
                 "tony.task.heartbeat-interval-ms": "250ms",
                 "tony.task.metrics-interval-ms": "2s",
                 "tony.task.term-grace-ms": "1m",
                 "tony.task.hb-failure-budget": 7,
                 "tony.am.orphan-grace-ms": 4500,
                 "tony.application.timeout": "1h",
                 "tony.srcdir": "/stage/src.zip",
                 "tony.python.venv": "gs://b/venv.zip#archive",
                 "tony.containers.resources": "a.txt,b.zip#archive",
                 "tony.worker.resources": "w.txt::renamed.txt",
                 "tony.worker.gpus": 2,
                 "tony.task.gpu-metrics.enabled": "off",
                 "tony.localization.cache-enabled": "yes",
                 "tony.tpu.mesh-shape": "2,2",
                 "tony.tpu.mesh-axes": "fsdp,tp",
                 "tony.profiler.hz": "7.5"}.items():
        conf.set(k, v, "test")
    conf.merge_cli(["tony.containers.resources=c.txt"])
    path = str(tmp_path / "tony-final.json")
    conf.write(path)
    assert _reads(PortConfiguration.read(path), K) \
        == _reads(TonyConfiguration.read(path), JK)
    # a plain JSON object, as both packages also accept
    plain = tmp_path / "plain.json"
    plain.write_text(json.dumps({"tony.task.metrics-interval-ms": "1s",
                                 "tony.worker.gpus": "1"}))
    assert _reads(PortConfiguration.read(str(plain)), K) \
        == _reads(TonyConfiguration.read(str(plain)), JK)


def test_default_conf_reads_equal_jax():
    """No frozen conf: the port's defaults are the JAX package's for
    every key the executor reads (sources too)."""
    assert _reads(PortConfiguration(), K) == _reads(TonyConfiguration(), JK)


# ---------------------------------------------------------------------------
# the task monitor
# ---------------------------------------------------------------------------

class _Recorder:
    def __init__(self, fail_every: int = 0):
        self.pushes = []
        self._fail_every = fail_every

    def update_metrics(self, task_type, index, metrics, attempt=-1,
                       **kw):
        self.pushes.append((task_type, index, metrics, attempt))
        if self._fail_every and len(self.pushes) % self._fail_every == 0:
            raise ConnectionError("the AM is away")


# duty/hbm samples: empty intervals, a duty-only one, a raising one
TPU_SEQ = [{"duty_cycle": 80.0, "hbm_bytes": 2.0e9}, {},
           {"duty_cycle": 0.0}, RuntimeError("driver hiccup"),
           {"hbm_bytes": 3.5e9}, {"duty_cycle": 97.5, "hbm_bytes": 1e9},
           {}, {"duty_cycle": 0.5, "hbm_bytes": 1.25e9}]
GPU_SEQ = [{}, {"util_max": 90.0, "util_avg": 45.0, "fb_pct_max": 50.0,
                "fb_pct_avg": 30.0, "main_pct_max": 2.0,
                "main_pct_avg": 1.0},
           RuntimeError("nvidia-smi hiccup"),
           {"util_max": 10.0, "util_avg": 5.0, "fb_pct_max": 55.0,
            "fb_pct_avg": 35.0, "main_pct_max": 3.0, "main_pct_avg": 1.5}]


def _sequence(items):
    it = iter(items)

    def sample():
        item = next(it)
        if isinstance(item, Exception):
            raise item
        return dict(item)
    return sample


def _monitor_pushes(module, fail_every: int) -> list:
    rec = _Recorder(fail_every)
    mon = module.TaskMonitor(
        rec, "worker", 3, pid_fn=lambda: None, interval_sec=60.0,
        tpu_sampler=_sequence(TPU_SEQ),
        gpu_sampler=_sequence(GPU_SEQ + [{}] * len(TPU_SEQ)), attempt=2)
    logging.disable(logging.CRITICAL)
    try:
        for _ in TPU_SEQ:
            mon._sample_and_push()
    finally:
        logging.disable(logging.NOTSET)
    return rec.pushes


@pytest.mark.parametrize("fail_every", [0, 3])
def test_task_monitor_snapshots_equal_jax(fail_every):
    got = _monitor_pushes(task_monitor, fail_every)
    want = _monitor_pushes(jmonitor, fail_every)
    assert len(got) == len(TPU_SEQ)
    assert got == want
    names = [{m["name"] for m in push[2]} for push in got]
    # the current duty only where its interval sampled one
    assert ["TPU_UTILIZATION" in n for n in names] == [
        True, False, True, False, False, True, False, True]


def test_monitor_metric_names_are_the_jax_names():
    for name in dir(jmonitor):
        if name.isupper() and name.endswith(("_BYTES", "_UTILIZATION",
                                             "_USAGE")):
            assert getattr(task_monitor, name) == getattr(jmonitor, name)


def test_tree_rss_covers_a_grandchild():
    """The task command runs through a shell: the tree holds bash's
    child, and its RSS counts."""
    proc = subprocess.Popen(["bash", "-c", "sleep 30 & wait"])
    try:
        deadline = time.monotonic() + 10
        tree = {proc.pid}
        while time.monotonic() < deadline and len(tree) < 2:
            tree = cuda_metrics.process_tree(proc.pid)
            time.sleep(0.05)
        assert len(tree) == 2 and proc.pid in tree
        assert task_monitor._proc_tree_rss_bytes(proc.pid) \
            == jmonitor._proc_tree_rss_bytes(proc.pid) > 0
    finally:
        subprocess.run(["pkill", "-P", str(proc.pid)], check=False)
        proc.kill()
        proc.wait(timeout=10)


# ---------------------------------------------------------------------------
# cuda_metrics over a stand-in for NVML
# ---------------------------------------------------------------------------

class FakeNvml:
    """NVML's C calls as cuda_metrics makes them: each fills the ctypes
    objects it was handed a reference to, and returns an NVML status."""

    def __init__(self, cards, init_rc=0):
        # cards: [{"minor", "util", "used", "total", "procs": [(pid, b)]}]
        self.cards = cards
        self.init_rc = init_rc
        self.calls = 0
        self.hang = None           # a threading.Event to block on

    def nvmlInit_v2(self):
        return self.init_rc

    def nvmlShutdown(self):
        return 0

    def nvmlDeviceGetCount_v2(self, count):
        count._obj.value = len(self.cards)
        return 0

    def nvmlDeviceGetHandleByIndex_v2(self, i, handle):
        handle._obj.value = 1000 + i
        return 0

    def _card(self, handle):
        return self.cards[handle.value - 1000]

    def nvmlDeviceGetMinorNumber(self, handle, minor):
        minor._obj.value = self._card(handle)["minor"]
        return 0

    def nvmlDeviceGetUtilizationRates(self, handle, util):
        if self.hang is not None:
            self.hang.wait(10)
        self.calls += 1
        util._obj.gpu = self._card(handle)["util"]
        util._obj.memory = 3
        return 0

    def nvmlDeviceGetMemoryInfo(self, handle, mem):
        card = self._card(handle)
        mem._obj.total, mem._obj.used = card["total"], card["used"]
        mem._obj.free = card["total"] - card["used"]
        return 0

    def nvmlDeviceGetComputeRunningProcesses_v3(self, handle, count, infos):
        procs = self._card(handle)["procs"]
        if count._obj.value < len(procs):
            count._obj.value = len(procs)
            return cuda_metrics.NVML_ERROR_INSUFFICIENT_SIZE
        for i, (pid, used) in enumerate(procs):
            infos[i].pid = pid
            infos[i].usedGpuMemory = used
            infos[i].gpuInstanceId = infos[i].computeInstanceId = 0xFFFFFFFF
        count._obj.value = len(procs)
        return 0


GIB = 1 << 30


def test_process_info_is_the_v2_layout_of_nvml_h():
    """nvmlProcessInfo_t (the _v3 call's): pid at 0, used bytes at 8, GPU
    and compute instance ids at 16 and 20; 24 bytes."""
    P = cuda_metrics.ProcessInfo
    assert ctypes.sizeof(P) == 24
    assert [P.pid.offset, P.usedGpuMemory.offset, P.gpuInstanceId.offset,
            P.computeInstanceId.offset] == [0, 8, 16, 20]
    assert ctypes.sizeof(cuda_metrics.Memory) == 24
    assert ctypes.sizeof(cuda_metrics.Utilization) == 8


def test_reader_decodes_cards_and_grows_its_buffer():
    many = [(5000 + i, i * GIB) for i in range(100)]
    fake = FakeNvml([
        {"minor": 0, "util": 97, "used": 30 * GIB, "total": 80 * GIB,
         "procs": [(41, 3 * GIB), (43, cuda_metrics.NVML_VALUE_NOT_AVAILABLE)]},
        {"minor": 3, "util": 0, "used": 200 * GIB, "total": 80 * GIB,
         "procs": many}])
    devices = cuda_metrics.NvmlReader(fake).sample()
    assert [(d.index, d.minor, d.utilization_pct, d.memory_used,
             d.memory_total) for d in devices] == [
        (0, 0, 97.0, 30 * GIB, 80 * GIB), (1, 3, 0.0, 200 * GIB, 80 * GIB)]
    assert devices[0].processes == [(41, 3 * GIB), (43, None)]
    assert devices[1].processes == many


def _no_maps(pid):
    return set()


def test_tree_pids_matched_across_two_cards():
    """Duty is the highest utilization over the cards the tree holds a
    context on; memory the sum of the tree's pids on them. Another
    process's card and context count for nothing."""
    fake = FakeNvml([
        {"minor": 0, "util": 35, "used": 9 * GIB, "total": 80 * GIB,
         "procs": [(101, 2 * GIB), (900, 6 * GIB)]},
        {"minor": 1, "util": 88, "used": 5 * GIB, "total": 80 * GIB,
         "procs": [(102, 4 * GIB)]},
        {"minor": 2, "util": 100, "used": 70 * GIB, "total": 80 * GIB,
         "procs": [(901, 70 * GIB)]}])
    devices = cuda_metrics.NvmlReader(fake).sample()
    tree = {100, 101, 102, 103}     # shell, trainer, rank 1, a worker
    assert cuda_metrics.card_use(devices, tree, maps=_no_maps) == {
        "duty_cycle": 88.0, "hbm_bytes": float(6 * GIB)}
    # the trainer alone
    assert cuda_metrics.card_use(devices, {101}, maps=_no_maps) == {
        "duty_cycle": 35.0, "hbm_bytes": float(2 * GIB)}


def test_a_tree_without_a_context_reports_no_duty():
    fake = FakeNvml([{"minor": 0, "util": 100, "used": 70 * GIB,
                      "total": 80 * GIB, "procs": [(901, 70 * GIB)]}])
    devices = cuda_metrics.NvmlReader(fake).sample()
    # 901 is a local process that maps the card: NVML's pids are ours
    maps = {901: {"/dev/nvidia0", cuda_metrics.UVM_DEVICE}}
    assert cuda_metrics.card_use(devices, {100, 101},
                                 maps=lambda p: maps.get(p, set())) == {}
    assert cuda_metrics.card_use([], {100}, maps=_no_maps) == {}


def test_pids_outside_this_namespace_fall_back_to_the_tree_mappings():
    """NVML names every context of a sandbox as one foreign pid (1 here,
    its memory repeated per context): the card counts as the tree's when
    a tree process maps the uvm device and the card's node; its memory is
    each distinct foreign entry once. A card the tree does not map, and a
    tree that holds no context (cuInit alone maps the node, not uvm),
    count for nothing."""
    fake = FakeNvml([
        {"minor": 4, "util": 100, "used": 6 * GIB, "total": 80 * GIB,
         "procs": [(1, 5 * GIB), (1, 5 * GIB)]},
        {"minor": 5, "util": 60, "used": 2 * GIB, "total": 80 * GIB,
         "procs": [(1, 2 * GIB)]}])
    devices = cuda_metrics.NvmlReader(fake).sample()
    maps = {101: {"/dev/nvidia4", "/dev/nvidia5", "/dev/nvidiactl"},
            102: {"/dev/nvidia4", "/dev/nvidiactl",
                  cuda_metrics.UVM_DEVICE}}
    look = lambda p: maps.get(p, set())  # noqa: E731
    assert cuda_metrics.card_use(devices, {100, 101, 102}, maps=look) == {
        "duty_cycle": 100.0, "hbm_bytes": float(5 * GIB)}
    assert cuda_metrics.card_use(devices, {100, 101}, maps=look) == {}


def test_card_sampler_walks_the_real_tree():
    """The sampler over this process's own child: its pid on a card is
    found through bash."""
    proc = subprocess.Popen(["bash", "-c", "sleep 30 & wait"])
    try:
        deadline = time.monotonic() + 10
        tree = {proc.pid}
        while time.monotonic() < deadline and len(tree) < 2:
            tree = cuda_metrics.process_tree(proc.pid)
            time.sleep(0.05)
        (child,) = tree - {proc.pid}
        fake = FakeNvml([{"minor": 0, "util": 64, "used": 3 * GIB,
                          "total": 80 * GIB, "procs": [(child, 3 * GIB)]}])
        sampler = cuda_metrics.CardSampler(cuda_metrics.NvmlReader(fake))
        assert sampler(proc.pid) == {"duty_cycle": 64.0,
                                     "hbm_bytes": float(3 * GIB)}
        assert sampler(None) == {}
    finally:
        subprocess.run(["pkill", "-P", str(proc.pid)], check=False)
        proc.kill()
        proc.wait(timeout=10)


def test_nvml_that_cannot_load_is_logged_once(caplog, monkeypatch):
    monkeypatch.setattr(cuda_metrics, "NVML_LIBRARY",
                        "libnvidia-ml-absent-for-this-test.so.1")
    sampler = cuda_metrics.CardSampler(cuda_metrics.NvmlReader())
    with caplog.at_level(logging.WARNING, logger=cuda_metrics.__name__):
        assert sampler(os.getpid()) == {}
        assert sampler(os.getpid()) == {}
    warned = [r for r in caplog.records if "NVML is unavailable" in
              r.getMessage()]
    assert len(warned) == 1
    # an NVML that refuses to start (NVML_ERROR_DRIVER_NOT_LOADED = 9)
    refused = cuda_metrics.CardSampler(cuda_metrics.NvmlReader(
        FakeNvml([], init_rc=9)))
    assert refused(os.getpid()) == {} and refused.read() is None


def test_a_hung_nvml_read_costs_an_interval_not_the_monitor():
    fake = FakeNvml([{"minor": 0, "util": 50, "used": GIB,
                      "total": 80 * GIB, "procs": [(os.getpid(), GIB)]}])
    fake.hang = threading.Event()
    sampler = cuda_metrics.CardSampler(cuda_metrics.NvmlReader(fake),
                                       timeout_sec=0.2)
    t0 = time.monotonic()
    assert sampler.read() is None           # timed out
    assert sampler.read() is None           # still in flight: not queued
    assert time.monotonic() - t0 < 2.0
    fake.hang.set()
    deadline = time.monotonic() + 5
    got = None
    while got is None and time.monotonic() < deadline:
        got = sampler.read()
    fake.hang = None
    assert got is not None and got[0].utilization_pct == 50.0


def test_default_sampler_without_nvml_and_torch_reports_nothing():
    """Off the card the executor process has neither source."""
    probe = (
        "import sys\n"
        "from tony_tpu_torch.executor import task_monitor as m\n"
        "import os\n"
        "print(m.default_tpu_sampler(None),"
        " m.default_tpu_sampler(os.getpid()), 'torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=60,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["{}", "{}", "False"]


# ---------------------------------------------------------------------------
# the live tail and the failure diagnostics
# ---------------------------------------------------------------------------

def _container(tmp_path):
    d = tmp_path / "container"
    d.mkdir()
    secret = "f" * 64
    (d / "stdout").write_text(
        "step 1 loss 3.2\nstep 2 loss 2.9\n" * 200 + "partial")
    (d / "stderr").write_text(
        "warning: TONY_SECURITY_TOKEN=" + secret + "\n"
        "Traceback (most recent call last):\n"
        "torch.OutOfMemoryError: CUDA out of memory. Tried to allocate\n"
        + "x" * 3000 + "\nAuthorization: Bearer abc.def\n")
    return str(d)


@pytest.mark.parametrize("exit_code", [1, -9, 137, 143, 0, None])
def test_failure_diagnostics_equal_jax(tmp_path, exit_code):
    d = _container(tmp_path)
    assert logs.classify_container_failure(d, exit_code, 20, 4096) \
        == jlogs.classify_container_failure(d, exit_code, 20, 4096)


@pytest.mark.parametrize("offset,max_bytes,final", [
    (-1, 0, False), (0, 300, False), (5, 0, True), (10**9, 0, False)])
def test_log_tail_chunks_equal_jax(tmp_path, offset, max_bytes, final):
    d = _container(tmp_path)
    for stream in logs.STREAMS:
        path = os.path.join(d, stream)
        got = logs.LogTail(path, 2048, 1024).read_chunk(offset, max_bytes,
                                                        final)
        want = jlogs.LogTail(path, 2048, 1024).read_chunk(offset, max_bytes,
                                                          final)
        assert got == want
        assert "f" * 64 not in got["data"]
