"""The port's configuration package against the JAX package's.

`tony_tpu_torch.conf` is the port's own copy of `tony_tpu/conf/`: every
key, default, typed getter, layering rule and the frozen `tony-final.json`
must be the JAX package's, since a job's configuration crosses processes
of either package (the AM freezes it, every executor and task reads it).
"""

from __future__ import annotations

import json
import os
import re

import pytest

from tony_tpu.conf import TonyConfiguration as JaxConf
from tony_tpu.conf import defaults as jdefaults
from tony_tpu.conf import keys as JK
from tony_tpu.conf import queues as jqueues
from tony_tpu.conf.configuration import (
    parse_memory_mb as jparse_memory_mb, parse_time_ms as jparse_time_ms,
)
from tony_tpu_torch.conf import TonyConfiguration as PortConf
from tony_tpu_torch.conf import defaults as pdefaults
from tony_tpu_torch.conf import keys as PK
from tony_tpu_torch.conf import queues as pqueues
from tony_tpu_torch.conf.configuration import (
    parse_memory_mb as pparse_memory_mb, parse_time_ms as pparse_time_ms,
)


def _public(module) -> dict:
    return {n: v for n, v in vars(module).items()
            if not n.startswith("_") and not callable(v)
            and not isinstance(v, type(re))}


def test_every_key_and_default_is_the_jax_packages():
    pkeys, jkeys = _public(PK), _public(JK)
    assert set(pkeys) == set(jkeys)
    for name, value in jkeys.items():
        if isinstance(value, re.Pattern):
            assert pkeys[name].pattern == value.pattern, name
        else:
            assert pkeys[name] == value, name
    assert pdefaults.DEFAULTS == jdefaults.DEFAULTS
    assert pdefaults.DEFAULTS[PK.APPLICATION_NAME] == "tony_tpu"
    assert pdefaults.NO_DEFAULT_KEYS == jdefaults.NO_DEFAULT_KEYS


_BUILDERS = sorted(n for n, v in vars(JK).items()
                   if n.endswith("_key") and callable(v))


@pytest.mark.parametrize("builder", _BUILDERS)
def test_dynamic_key_builders_agree(builder):
    extra = ("instances",) * (getattr(JK, builder).__code__.co_argcount - 1)
    for arg in ("worker", "ps", "serving", "prod"):
        assert getattr(PK, builder)(arg, *extra) \
            == getattr(JK, builder)(arg, *extra)


@pytest.mark.parametrize("value", [0, 250, "500ms", "5s", "2m", "1h", "1d",
                                   " 3 s ", "1.5s", 7.9])
def test_parse_time_ms_agrees(value):
    assert pparse_time_ms(value) == jparse_time_ms(value)


@pytest.mark.parametrize("value", [2048, "2g", "512m", "512", "1k", "0",
                                   "1t", "1.5g"])
def test_parse_memory_mb_agrees(value):
    assert pparse_memory_mb(value) == jparse_memory_mb(value)


@pytest.mark.parametrize("bad", ["fast", "5 parsecs", "ms"])
def test_bad_durations_raise_in_both(bad):
    for parse in (pparse_time_ms, jparse_time_ms):
        with pytest.raises(ValueError):
            parse(bad)


_SETTINGS = {
    "tony.worker.instances": 2,
    "tony.ps.instances": "1",
    "tony.worker.tpus": 4,
    "tony.worker.memory": "2g",
    "tony.task.heartbeat-interval-ms": "250ms",
    "tony.am.monitor-interval-ms": 100,
    "tony.application.security.enabled": "off",
    "tony.task.metrics-interval-ms": "2s",
    "tony.straggler.z-threshold": "2.5",
    "tony.serving.slots": 2,
    "tony.containers.resources": "a.txt,b.zip#archive",
    "tony.worker.command": "python train.py",
}


def _both(settings=_SETTINGS, source="test"):
    confs = (JaxConf(), PortConf())
    for conf in confs:
        for k, v in settings.items():
            conf.set(k, v, source)
    return confs


@pytest.mark.parametrize("getter,key,default", [
    ("get", "tony.worker.instances", None),
    ("get_str", "tony.worker.command", ""),
    ("get_str", "tony.missing", "dflt"),
    ("get_int", "tony.ps.instances", 0),
    ("get_int", "tony.missing", 7),
    ("get_float", "tony.straggler.z-threshold", 0.0),
    ("get_bool", "tony.application.security.enabled", True),
    ("get_bool", "tony.missing", True),
    ("get_time_ms", "tony.task.heartbeat-interval-ms", 0),
    ("get_time_ms", "tony.task.metrics-interval-ms", 0),
    ("get_memory_mb", "tony.worker.memory", 0),
    ("get_strings", "tony.containers.resources", None),
    ("source_of", "tony.worker.instances", None),
    ("source_of", "tony.am.retry-count", None),
    ("source_of", "tony.missing", None),
])
def test_typed_getters_agree(getter, key, default):
    jconf, pconf = _both()
    args = (key,) if default is None else (key, default)
    assert getattr(pconf, getter)(*args) == getattr(jconf, getter)(*args)


def test_layering_and_iteration_agree(tmp_path, monkeypatch):
    props = tmp_path / "job.properties"
    props.write_text("# a comment\ntony.worker.instances = 3\n"
                     "tony.containers.resources=c.txt\n")
    js = tmp_path / "job.json"
    js.write_text(json.dumps({"tony.ps.instances": 2,
                              "tony.containers.resources": "d.txt"}))
    site_dir = tmp_path / "site"
    site_dir.mkdir()
    (site_dir / "tony-site.json").write_text(
        json.dumps({"tony.am.retry-count": 1}))
    monkeypatch.setenv("TONY_CONF_DIR", str(site_dir))
    views = []
    for conf in _both():
        conf.merge_file(str(props))
        conf.merge_file(str(js), source="user")
        conf.merge_cli(["tony.evaluator.instances=1",
                        "tony.containers.resources=a.txt"])
        conf.merge_site()
        views.append((conf.entries_with_sources(), conf.job_types(),
                      list(conf), conf.to_dict(),
                      "tony.ps.instances" in conf))
    assert views[0] == views[1]
    for conf in _both():
        with pytest.raises(ValueError):
            conf.merge_cli(["no-equals-sign"])


def test_write_is_the_jax_file_byte_for_byte(tmp_path):
    jconf, pconf = _both()
    jconf.write(str(tmp_path / "jax" / "tony-final.json"))
    pconf.write(str(tmp_path / "port" / "tony-final.json"))
    assert (tmp_path / "port" / "tony-final.json").read_bytes() == \
        (tmp_path / "jax" / "tony-final.json").read_bytes()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_reads_the_others_file(tmp_path, writer):
    jconf, pconf = _both()
    path = str(tmp_path / "tony-final.json")
    (jconf if writer == "jax" else pconf).write(path)
    back_j, back_p = JaxConf.read(path), PortConf.read(path)
    assert back_p.entries_with_sources() == back_j.entries_with_sources()
    assert back_p.entries_with_sources() == jconf.entries_with_sources()
    # a plain JSON object, as both packages also accept
    plain = tmp_path / "plain.json"
    plain.write_text(json.dumps({"tony.worker.instances": "1"}))
    assert PortConf.read(str(plain)).entries_with_sources() == \
        JaxConf.read(str(plain)).entries_with_sources()


def test_from_env_reads_the_frozen_file(tmp_path):
    path = str(tmp_path / "tony-final.json")
    _both()[1].write(path)
    conf = PortConf.from_env({"TONY_CONF_PATH": path})
    assert conf.get_int("tony.worker.instances") == 2
    assert PortConf.from_env({}).to_dict() == PortConf().to_dict()


_QUEUES = {
    "tony.queues.prod.max-tpus": 8,
    "tony.queues.prod.parent": "",
    "tony.queues.dev.max-tpus": 4,
    "tony.queues.dev.parent": "prod",
}


@pytest.mark.parametrize("case", [
    {},
    {"tony.worker.instances": 2, "tony.worker.tpus": 4},
    dict(_QUEUES, **{"tony.application.queue": "prod",
                     "tony.worker.instances": 2, "tony.worker.tpus": 4}),
    dict(_QUEUES, **{"tony.application.queue": "prod",
                     "tony.worker.instances": 3, "tony.worker.tpus": 4}),
    dict(_QUEUES, **{"tony.application.queue": "dev",
                     "tony.worker.instances": 2, "tony.worker.tpus": 4}),
    dict(_QUEUES, **{"tony.application.queue": "nope",
                     "tony.worker.instances": 1}),
    dict(_QUEUES, **{"tony.application.queue": "dev",
                     "tony.application.priority": 3,
                     "tony.serving.instances": 1, "tony.serving.tpus": 1}),
])
def test_queue_quota_agrees(case):
    jconf, pconf = _both(case)
    outcomes = []
    for mod, conf in ((jqueues, jconf), (pqueues, pconf)):
        try:
            mod.validate_queue_quota(conf)
            verdict = "ok"
        except ValueError as e:
            verdict = f"refused: {e}"
        specs = {n: vars(s) for n, s in mod.queue_specs(conf).items()}
        outcomes.append((verdict, mod.app_queue(conf), mod.app_priority(conf),
                         mod.total_requested_tpus(conf),
                         mod.configured_queues(conf), specs))
    assert outcomes[0] == outcomes[1]


def test_port_conf_package_imports_no_jax_package():
    import tony_tpu_torch.conf.configuration as cfg
    src = open(cfg.__file__).read() + open(os.path.join(
        os.path.dirname(cfg.__file__), "queues.py")).read()
    assert "import tony_tpu\n" not in src and "from tony_tpu." not in src
