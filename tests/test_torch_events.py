"""The port's job history against the JAX package's: the event schema,
the `.jhist` writer and reader, the history file names and the sidecar
files the AM flushes beside the event log.

A job's history is read by the JAX package's portal and CLI whichever
AM wrote it, so every event must serialise to the same bytes and a file
written by either package's handler must parse under the other's.
"""

from __future__ import annotations

import dataclasses
import json
import os
import typing

import pytest

from tony_tpu.events import handler as jhandler
from tony_tpu.events import history as jhistory
from tony_tpu.events import schema as jschema
from tony_tpu_torch.events import handler as phandler
from tony_tpu_torch.events import history as phistory
from tony_tpu_torch.events import schema as pschema


def _value(f: dataclasses.Field, salt: int):
    """A value of the field's declared type, different for each field."""
    kind = str(f.type)
    if kind.startswith("list"):
        return [{"name": f"M{salt}", "value": salt + 0.5}]
    if kind.startswith("dict"):
        return {"k": salt}
    if kind == "bool":
        return bool(salt % 2)
    if kind == "int":
        return 100 + salt
    if kind == "float":
        return salt + 0.25
    return f"{f.name}-{salt}"


def _payload(module, etype: str):
    cls = module._PAYLOADS[module.EventType(etype)]
    return cls(**{f.name: _value(f, i)
                  for i, f in enumerate(dataclasses.fields(cls))})


def _event(module, etype: str, ts: int = 1_700_000_000_123):
    return module.Event(module.EventType(etype), _payload(module, etype), ts)


EVENT_TYPES = [t.value for t in jschema.EventType]


def test_the_event_types_are_the_jax_packages():
    assert [t.value for t in pschema.EventType] == EVENT_TYPES
    for etype in EVENT_TYPES:
        pcls = pschema._PAYLOADS[pschema.EventType(etype)]
        jcls = jschema._PAYLOADS[jschema.EventType(etype)]
        assert pcls.__name__ == jcls.__name__
        assert [(f.name, str(f.type)) for f in dataclasses.fields(pcls)] \
            == [(f.name, str(f.type)) for f in dataclasses.fields(jcls)]


@pytest.mark.parametrize("etype", EVENT_TYPES)
def test_every_event_serialises_to_the_same_bytes(etype):
    port, jax_ = _event(pschema, etype), _event(jschema, etype)
    assert json.dumps(port.to_dict()) == json.dumps(jax_.to_dict())
    # and reads back under the other package's schema, field for field
    back = jschema.Event.from_dict(port.to_dict())
    assert back.to_dict() == jax_.to_dict()
    back = pschema.Event.from_dict(jax_.to_dict())
    assert back.to_dict() == port.to_dict()


def _write_jhist(history, handler, schema, hist_dir, status="FAILED"):
    md = history.JobMetadata("application_1_0001", started=1_700_000_000_000,
                             user="alice-b")
    h = handler.EventHandler(str(hist_dir), md)
    h.start()
    for etype in EVENT_TYPES:
        h.emit(_event(schema, etype))
    return h.stop(status)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_jhist_of_either_handler_parses_under_the_other(tmp_path, writer):
    if writer == "port":
        path = _write_jhist(phistory, phandler, pschema, tmp_path)
    else:
        path = _write_jhist(jhistory, jhandler, jschema, tmp_path)
    by_port = [e.to_dict() for e in phandler.parse_events(path)]
    by_jax = [e.to_dict() for e in jhandler.parse_events(path)]
    assert by_port == by_jax
    assert [e["type"] for e in by_port] == EVENT_TYPES
    name = os.path.basename(path)
    assert vars(phistory.parse_history_file_name(name)) \
        == vars(jhistory.parse_history_file_name(name))


def test_both_handlers_write_the_same_lines(tmp_path):
    p = _write_jhist(phistory, phandler, pschema, tmp_path / "p", "SUCCEEDED")
    j = _write_jhist(jhistory, jhandler, jschema, tmp_path / "j", "SUCCEEDED")
    with open(p, "rb") as fp, open(j, "rb") as fj:
        assert fp.read() == fj.read()
    # the final names differ only in their completion time
    mp = phistory.parse_history_file_name(os.path.basename(p))
    mj = jhistory.parse_history_file_name(os.path.basename(j))
    mp.completed = mj.completed = 0
    assert vars(mp) == vars(mj)


@pytest.mark.parametrize("status", ["SUCCEEDED", "FAILED", "KILLED",
                                    "PREEMPTED"])
def test_history_file_names_match(status):
    for user in ("root", "alice-b", "svc-x-1"):
        kw = dict(application_id="application_17_0002",
                  started=1_700_000_000_000, completed=1_700_000_050_000,
                  user=user, status=status)
        pm, jm = phistory.JobMetadata(**kw), jhistory.JobMetadata(**kw)
        for fn in ("inprogress_file_name", "history_file_name"):
            name = getattr(phistory, fn)(pm)
            assert name == getattr(jhistory, fn)(jm)
            assert vars(phistory.parse_history_file_name(name)) \
                == vars(jhistory.parse_history_file_name(name))
    for bad in ("x.jhist", "app-1-root.txt"):
        for mod in (phistory, jhistory):
            with pytest.raises(ValueError):
                mod.parse_history_file_name(bad)


def test_resume_adopts_the_jax_in_progress_file(tmp_path):
    """A port AM recovering a job adopts the in-progress file the crashed
    attempt left, so the job ends with one `.jhist`."""
    md = jhistory.JobMetadata("app_r", started=1_700_000_000_000,
                              user="root")
    first = jhandler.EventHandler(str(tmp_path), md)
    first.start()
    first.emit(_event(jschema, "APPLICATION_INITED"))
    first._queue.put(None)
    first._thread.join(timeout=10)
    first._file.close()
    second = phandler.EventHandler(
        str(tmp_path), phistory.JobMetadata("app_r", started=5), resume=True)
    second.start()
    second.emit(_event(pschema, "APPLICATION_FINISHED"))
    final = second.stop("SUCCEEDED")
    assert os.listdir(tmp_path) == [os.path.basename(final)]
    assert [e.type.value for e in jhandler.parse_events(final)] \
        == ["APPLICATION_INITED", "APPLICATION_FINISHED"]
    assert jhistory.parse_history_file_name(
        os.path.basename(final)).started == 1_700_000_000_000


_SIDECARS = [
    ("write_spans_file", [{"name": "application", "span_id": "a1",
                           "start_ms": 1, "end_ms": 2}]),
    ("write_metrics_file", {"worker:0": {"TPU_UTILIZATION": [[1, 97.5]]}}),
    ("write_goodput_file", {"job": {"goodput_pct": 81.5}, "tasks": {}}),
    ("write_diagnostics_file", {"status": "FAILED", "first_failure": None,
                                "message": "tony.alerts.rules=x"}),
    ("write_jobstate_file", {"app_id": "a", "state": "SUCCEEDED"}),
    ("write_skew_file", {"signals": {}, "stragglers": []}),
    ("write_alerts_file", {"firing": [], "log": []}),
    ("write_serving_traces_file", [{"trace_id": "t", "hops": [],
                                    "note": "Bearer abc.def"}]),
    ("write_profile_file", "MainThread;main;loop 12\n"),
]


@pytest.mark.parametrize("writer,payload", _SIDECARS,
                         ids=[w for w, _ in _SIDECARS])
def test_sidecar_files_are_the_jax_bytes(tmp_path, writer, payload):
    getattr(phistory, writer)(str(tmp_path / "p"), payload)
    getattr(jhistory, writer)(str(tmp_path / "j"), payload)
    [pname] = os.listdir(tmp_path / "p")
    [jname] = os.listdir(tmp_path / "j")
    assert pname == jname
    assert (tmp_path / "p" / pname).read_bytes() \
        == (tmp_path / "j" / jname).read_bytes()
    reader = writer.replace("write_", "read_")
    if hasattr(jhistory, reader):
        assert getattr(phistory, reader)(str(tmp_path / "j")) \
            == getattr(jhistory, reader)(str(tmp_path / "p"))


def test_schema_annotations_resolve():
    # the payload classes are plain dataclasses whose annotations name
    # only builtins, so the port's copy resolves without the JAX package
    for cls in pschema._PAYLOADS.values():
        typing.get_type_hints(cls)
