"""TonyClient: job submission + monitoring.

Equivalent of the reference's TonyClient.java:1107 LoC:

- `init` — CLI args → cascaded conf (defaults ← conf_file ← -conf k=v ←
  site), task-command construction, limit validation
  (TonyClient.java:346-451,483-517,598-667,454-475).
- `run` — create the app, stage resources + frozen conf into the per-app
  dir, launch the AM, monitor (TonyClient.java:155-186,189-266,838-892).
- listener callbacks mirroring `updateTaskInfos` (TonyClient.java:894-920).

The YARN RM of the reference is replaced by the process substrate: the AM is
spawned directly as a child process (local backend). The monitor loop polls
the AM status artifact + the task-info RPC exactly like the reference polled
`yarnClient.getApplicationReport` + `amRpcClient.getTaskInfos`.
"""

from __future__ import annotations

import argparse
import itertools
import logging
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import json
from typing import Callable, Optional

from tony_tpu_torch import constants as C
from tony_tpu_torch.conf import TonyConfiguration, keys as K
from tony_tpu_torch.rpc.client import ClusterServiceClient
from tony_tpu_torch.rpc.messages import TaskInfo
from tony_tpu_torch.utils.common import framework_pythonpath
from tony_tpu_torch.utils.fs import zip_dir
from tony_tpu_torch.utils.localization import stage_resource

LOG = logging.getLogger(__name__)

ClientListener = Callable[[list[TaskInfo]], None]


def build_arg_parser() -> argparse.ArgumentParser:
    """CLI surface mirroring the reference's options (TonyClient.java:330-340)."""
    p = argparse.ArgumentParser(prog="tony_tpu_torch", add_help=True)
    p.add_argument("--executes", help="command (or python file) each task runs")
    p.add_argument("--task_params", default="",
                   help="args appended to the python file")
    p.add_argument("--conf_file", help="job conf file (json or k=v lines)")
    p.add_argument("--conf", action="append", default=[],
                   help="k=v override, repeatable")
    p.add_argument("--src_dir", help="directory with training code, shipped "
                                     "to every container")
    p.add_argument("--python_venv", help="zipped venv shipped to containers")
    p.add_argument("--python_binary_path", help="python inside the venv")
    p.add_argument("--shell_env", action="append", default=[],
                   help="k=v env passed into task containers, repeatable")
    p.add_argument("--app_name", help="application name")
    p.add_argument("--queue",
                   help="scheduler queue; quota declared via "
                        "tony.queues.<name>.max-tpus (no queues "
                        "configured = tag only)")
    return p


class TonyClient:
    def __init__(self, conf: Optional[TonyConfiguration] = None):
        self.conf = conf or TonyConfiguration()
        self.app_id = ""
        self.app_dir = ""
        self.task_command = ""
        self._am_proc: Optional[subprocess.Popen] = None
        self._rpc: Optional[ClusterServiceClient] = None
        self._rpc_hostport = ""      # amhostport content the channel targets
        self._auth_token: Optional[str] = None
        self._listeners: list[ClientListener] = []
        self._last_infos: dict[str, str] = {}
        self.final_status = "UNDEFINED"
        self.final_message: Optional[str] = None

    @property
    def auth_token(self) -> Optional[str]:
        """The app secret when security is enabled (None otherwise);
        consumers (notebook proxy, portal) gate access with it."""
        return self._auth_token

    # ------------------------------------------------------------------
    def add_listener(self, listener: ClientListener) -> None:
        self._listeners.append(listener)

    def init(self, argv: list[str]) -> None:
        """Parse args and build the final conf (TonyClient.init,
        TonyClient.java:346-451)."""
        args, unknown = build_arg_parser().parse_known_args(argv)
        if unknown:
            raise ValueError(f"unknown arguments: {unknown}")
        if args.conf_file:
            self.conf.merge_file(args.conf_file)
        self.conf.merge_cli(args.conf)
        self.conf.merge_site()
        # build stamping (reference: VersionInfo injection, TonyClient.java:152)
        from tony_tpu_torch.version import stamp_conf
        stamp_conf(self.conf)
        if args.app_name:
            self.conf.set(K.APPLICATION_NAME, args.app_name, "cli")
        if args.queue:
            self.conf.set(K.APPLICATION_QUEUE, args.queue, "cli")
        if args.src_dir:
            self.conf.set(K.SRC_DIR, args.src_dir, "cli")
        if args.python_venv:
            self.conf.set(K.PYTHON_VENV, args.python_venv, "cli")
        if args.python_binary_path:
            self.conf.set(K.PYTHON_BINARY_PATH, args.python_binary_path, "cli")
        for entry in args.shell_env:
            self.conf.set(K.EXECUTION_ENV, entry, "cli")
        self.task_command = self._build_task_command(args)
        if self.task_command:
            self.conf.set(K.TASK_COMMAND, self.task_command, "cli")
        self.validate_conf()

    def _build_task_command(self, args) -> str:
        """(TonyClient.buildTaskCommand, TonyClient.java:454-475)."""
        if not args.executes:
            return ""
        executes = args.executes
        # A relative script path is resolved at submission time when the
        # file exists locally and no src_dir (flag or conf) will localize it
        # into the container cwd (containers run in their own scratch dirs).
        if (not os.path.isabs(executes) and os.path.isfile(executes)
                and not args.src_dir and not self.conf.get_str(K.SRC_DIR)):
            executes = os.path.abspath(executes)
        is_python_file = executes.endswith(".py")
        if is_python_file:
            python = (args.python_binary_path
                      or self.conf.get_str(K.PYTHON_BINARY_PATH)
                      or sys.executable)
            # venv-relative python binary (reference: appended to venv dir)
            if args.python_venv and not os.path.isabs(python):
                python = os.path.join("venv", python)
            cmd = f"{python} {executes}"
            if args.task_params:
                cmd += f" {args.task_params}"
            return cmd
        if args.task_params:
            return f"{executes} {args.task_params}"
        return executes

    def validate_conf(self) -> None:
        """Instance/resource caps (TonyClient.validateTonyConf,
        TonyClient.java:598-667)."""
        jobs = self.conf.job_types()
        total_instances = 0
        total_tpus = 0
        total_gpus = 0
        for job in jobs:
            num = self.conf.get_int(K.instances_key(job), 0)
            max_num = self.conf.get_int(K.max_instances_key(job), -1)
            if 0 <= max_num < num:
                raise ValueError(
                    f"{job}: requested {num} instances > max allowed {max_num}")
            total_instances += num
            total_tpus += num * self.conf.get_int(K.tpus_key(job), 0)
            total_gpus += num * self.conf.get_int(K.gpus_key(job), 0)
        max_total = self.conf.get_int(K.MAX_TOTAL_INSTANCES, -1)
        if 0 <= max_total < total_instances:
            raise ValueError(
                f"requested {total_instances} total instances > max allowed "
                f"{max_total}")
        max_tpus = self.conf.get_int(K.MAX_TOTAL_TPUS, -1)
        if 0 <= max_tpus < total_tpus:
            raise ValueError(
                f"requested {total_tpus} total TPUs > max allowed {max_tpus}")
        max_gpus = self.conf.get_int(K.MAX_TOTAL_GPUS, -1)
        if 0 <= max_gpus < total_gpus:
            raise ValueError(
                f"requested {total_gpus} total GPUs > max allowed {max_gpus}")
        # queue quota (TonyClient.java:249-251's YARN queue, re-based on
        # declared tony.queues.<name>.max-tpus — see conf/queues.py)
        from tony_tpu_torch.conf.queues import validate_queue_quota
        validate_queue_quota(self.conf)

    # ------------------------------------------------------------------
    def run(self) -> bool:
        """Submit + monitor to completion; returns success
        (TonyClient.run, TonyClient.java:155-186)."""
        self.submit()
        try:
            return self.monitor()
        finally:
            self.cleanup()

    # process-wide submission counter: two clients submitting from one
    # process in the same millisecond (multi-job launchers, the fleet e2e)
    # must never mint the same application id and clobber each other's
    # app dir
    _submit_seq = itertools.count()

    def submit(self) -> str:
        # explicit separator: pid+seq concatenated without one is
        # ambiguous once either field outgrows its padding
        self.app_id = (f"application_{int(time.time() * 1000)}"
                       f"_{os.getpid():05d}"
                       f"_{next(TonyClient._submit_seq):03d}")
        workdir = self.conf.get_str(K.CLUSTER_WORKDIR) or os.path.join(
            tempfile.gettempdir(), "tony_tpu")
        self.app_dir = os.path.join(workdir, self.app_id)
        os.makedirs(self.app_dir, exist_ok=True)
        # security: mint the per-app secret BEFORE the AM starts so it can
        # require it on its RPC servers (reference: RM-issued AM master key,
        # ApplicationMaster.java:432-452; here the client is the issuer)
        if self.conf.get_bool(K.APPLICATION_SECURITY_ENABLED, False):
            from tony_tpu_torch.security import generate_token, write_token_file
            self._auth_token = generate_token()
            write_token_file(self.app_dir, self._auth_token)
        # trace seed: the AM back-fills a client_submit span from this
        # (start = now, end = AM boot), covering staging + AM launch —
        # the one phase the AM itself cannot time
        try:
            with open(os.path.join(self.app_dir, C.TRACE_SEED_FILE), "w",
                      encoding="utf-8") as f:
                json.dump({"trace_id": self.app_id,
                           "submit_ms": int(time.time() * 1000)}, f)
        except OSError:
            LOG.debug("could not write trace seed", exc_info=True)
        self._process_final_conf()
        am_stdout = open(os.path.join(self.app_dir, C.AM_STDOUT), "ab")
        am_stderr = open(os.path.join(self.app_dir, C.AM_STDERR), "ab")
        env = dict(os.environ)
        env["PYTHONPATH"] = framework_pythonpath()
        # tony.am.max-attempts > 1: launch through the supervisor, which
        # relaunches a crashed AM process with journal replay + gang
        # adoption (am/supervisor.py — the local substrate's stand-in for
        # the reference's YARN-managed AM retry). Same process group and
        # stdio files, so kill()/monitor()'s process-died logic is
        # unchanged: the supervisor exits only once the AM's lifecycle is
        # truly over.
        module = ("tony_tpu_torch.am.supervisor"
                  if self.conf.get_int(K.AM_MAX_ATTEMPTS, 1) > 1
                  else "tony_tpu_torch.am")
        self._am_proc = subprocess.Popen(
            [sys.executable, "-m", module,
             "--app_id", self.app_id, "--app_dir", self.app_dir],
            stdout=am_stdout, stderr=am_stderr, env=env,
            start_new_session=True)
        LOG.info("submitted %s (%s pid %d), app dir %s",
                 self.app_id, module, self._am_proc.pid, self.app_dir)
        return self.app_id

    def _process_final_conf(self) -> None:
        """Stage src/venv/resources through the staging store and freeze
        the conf (TonyClient.processFinalTonyConf, TonyClient.java:189-228).
        The store is the HDFS-upload seam: a local dir on shared-fs
        deployments, gs:// for multi-host TPU pods (tony.staging.location)."""
        from tony_tpu_torch.storage import staging_store
        staging = staging_store(
            self.conf.get_str(K.STAGING_LOCATION, ""), self.app_dir)
        src_dir = self.conf.get_str(K.SRC_DIR)
        if src_dir:
            if not os.path.isdir(src_dir):
                raise FileNotFoundError(f"src_dir not found: {src_dir}")
            with tempfile.TemporaryDirectory() as tmp:
                zip_path = os.path.join(tmp, C.TONY_SRC_ZIP)
                zip_dir(src_dir, zip_path)
                staged_src = staging.put(zip_path, C.TONY_SRC_ZIP)
            self.conf.set(K.SRC_DIR, staged_src, "client-staged")
        venv = self.conf.get_str(K.PYTHON_VENV)
        if venv:
            if not os.path.exists(venv):
                raise FileNotFoundError(f"python venv not found: {venv}")
            staged = stage_resource(venv, staging)
            self.conf.set(K.PYTHON_VENV, staged, "client-staged")
        # per-jobtype + global container resources (path[::name][#archive])
        for job in self.conf.job_types():
            key = K.resources_key(job)
            specs = self.conf.get_strings(key)
            if specs:
                staged_specs = [stage_resource(s, staging) for s in specs]
                self.conf.set(key, ",".join(staged_specs), "client-staged")
        global_specs = self.conf.get_strings(K.CONTAINERS_RESOURCES)
        if global_specs:
            self.conf.set(K.CONTAINERS_RESOURCES,
                          ",".join(stage_resource(s, staging)
                                   for s in global_specs),
                          "client-staged")
        self.conf.write(os.path.join(self.app_dir, C.TONY_FINAL_CONF))

    # ------------------------------------------------------------------
    def monitor(self) -> bool:
        """Poll app state @1 s like the reference client
        (TonyClient.monitorApplication, TonyClient.java:838-892)."""
        status_path = os.path.join(self.app_dir, C.AM_STATUS_FILE)
        hostport_path = os.path.join(self.app_dir, C.AM_HOSTPORT_FILE)
        while True:
            status = self._read_status(status_path)
            if status is not None:
                self.final_status = status.get("status", "FAILED")
                self.final_message = status.get("message")
                self._update_task_infos()
                self._signal_finish()
                LOG.info("application %s finished: %s (%s)", self.app_id,
                         self.final_status, self.final_message)
                return self.final_status == "SUCCEEDED"
            if self._am_proc is not None and self._am_proc.poll() is not None:
                # AM died without writing a status file — crashed
                status = self._read_status(status_path)
                if status is None:
                    self.final_status = "FAILED"
                    self.final_message = (
                        f"AM process exited unexpectedly with code "
                        f"{self._am_proc.returncode}")
                    LOG.error(self.final_message)
                    return False
                continue
            if os.path.exists(hostport_path):
                # content-change-aware: a recovering AM attempt re-binds
                # on a fresh port and rewrites amhostport — the client
                # must follow it or every RPC after an AM restart times
                # out against the dead address
                self._init_rpc(hostport_path)
            self._update_task_infos()
            time.sleep(0.2)

    def _read_status(self, path: str) -> Optional[dict]:
        if not os.path.exists(path):
            return None
        try:
            with open(path, "r", encoding="utf-8") as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return None

    def _init_rpc(self, hostport_path: str) -> None:
        """(TonyClient.initRpcClientAndLogAMUrl, TonyClient.java:922-943).
        Idempotent per address: re-reads amhostport and rebuilds the
        channel only when the content changed (AM recovery re-bind)."""
        try:
            with open(hostport_path, "r", encoding="utf-8") as f:
                hostport = f.read().strip()
            if not hostport or hostport == self._rpc_hostport:
                return
            host, _, port = hostport.rpartition(":")
            rpc = ClusterServiceClient(host, int(port), retries=2,
                                       retry_sleep_sec=0.2,
                                       timeout_sec=5.0,
                                       auth_token=self._auth_token)
            if self._rpc is not None:
                LOG.info("AM re-bound: RPC %s -> %s", self._rpc_hostport,
                         hostport)
                self._rpc.close()
            else:
                LOG.info("AM RPC at %s", hostport)
            self._rpc = rpc
            self._rpc_hostport = hostport
        except (OSError, ValueError):
            LOG.warning("could not read AM hostport yet")

    def _update_task_infos(self) -> None:
        """Mirror task status to listeners on change
        (TonyClient.updateTaskInfos, TonyClient.java:894-920)."""
        if self._rpc is None:
            return
        try:
            infos = [TaskInfo.from_dict(d) for d in self._rpc.get_task_infos()]
        except Exception:  # noqa: BLE001 — AM may be mid-shutdown
            return
        changed = False
        for info in infos:
            prev = self._last_infos.get(info.task_id)
            if prev != info.status.value:
                self._last_infos[info.task_id] = info.status.value
                changed = True
                LOG.info("task %s -> %s (%s)", info.task_id,
                         info.status.value, info.url)
        if changed:
            for listener in self._listeners:
                listener(infos)

    def _signal_finish(self) -> None:
        """Tell the AM it may unregister (TonyClient.java:885-889)."""
        if self._rpc is not None:
            try:
                self._rpc.finish_application()
            except Exception:  # noqa: BLE001
                pass

    # ------------------------------------------------------------------
    def get_task_infos(self) -> list[TaskInfo]:
        if self._rpc is None:
            return []
        try:
            return [TaskInfo.from_dict(d) for d in self._rpc.get_task_infos()]
        except Exception:  # noqa: BLE001
            return []

    def kill(self) -> None:
        """Stop the application: finish-signal first, then escalate SIGTERM →
        SIGKILL so the AM always gets a window to stop its containers and
        write history (TonyClient.forceKillApplication equivalent)."""
        if self._am_proc is None or self._am_proc.poll() is not None:
            return
        if self._rpc is not None:
            try:
                self._rpc.finish_application()
            except Exception:  # noqa: BLE001
                pass
            try:
                self._am_proc.wait(timeout=10)
                return
            except subprocess.TimeoutExpired:
                pass
        try:
            os.killpg(self._am_proc.pid, signal.SIGTERM)
            self._am_proc.wait(timeout=10)
        except (ProcessLookupError, subprocess.TimeoutExpired):
            try:
                os.killpg(self._am_proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            self._am_proc.wait()

    def cleanup(self, remove_app_dir: bool = False) -> None:
        self.kill()
        if self._rpc is not None:
            self._rpc.close()
            self._rpc = None
        if remove_app_dir and self.app_dir and os.path.isdir(self.app_dir):
            shutil.rmtree(self.app_dir, ignore_errors=True)


def main(argv: Optional[list[str]] = None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    client = TonyClient()
    client.init(argv if argv is not None else sys.argv[1:])
    return 0 if client.run() else 1


if __name__ == "__main__":
    sys.exit(main())
