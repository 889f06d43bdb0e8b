"""The port's VBUS wire (``volcano_tpu_torch/bus/protocol.py`` and the
server's frame assembly) against the JAX package's, byte for byte.

The same payload encodes to the same bytes through both packages'
``encode_payload`` and ``send_frame``, in JSON and (with msgpack) in the
binary codec; every kind of the port's ``KINDS`` makes a lossless round
trip through both packages' ``encode_obj``/``decode_obj``, with the
wire dicts equal; the version, message-type, op and error tables are the
reference's where the port keeps an entry; the server's watch-batch
splices and the writer's coalescing give the reference's bytes.
"""

from __future__ import annotations

import json
import socket
import threading

import pytest

from tests.torch_bus_helpers import one_torch_thread, pkg  # noqa: F401 — autouse fixture

PORT, JAX = pkg("port"), pkg("jax")


def _meta(p, name, ns="ns"):
    return dict(name=name, namespace=ns, uid=f"uid-{name}", labels={"app": name},
                annotations={"note": "serde"}, resource_version=7, creation_timestamp=123.5,
                owner_references=[p.core.OwnerReference(kind="PodGroup", name="owner",
                                                        uid="uid-owner", controller=True)])


def exemplar(p, kind: str):
    """An object of ``kind`` in package ``p`` with non-default fields
    (the reference's serde exemplars, tests/test_bus.py)."""
    from volcano_tpu.apis import scheme as jax_scheme
    from volcano_tpu_torch.apis import scheme as port_scheme

    from importlib import import_module

    core, sched = p.core, p.scheduling
    scheme = port_scheme if p.name == "port" else jax_scheme
    root = "volcano_tpu_torch" if p.name == "port" else "volcano_tpu"
    batch, apis_bus = import_module(root + ".apis.batch"), import_module(root + ".apis.bus")
    m = core.ObjectMeta(**_meta(p, f"{kind.lower()}0"))
    if kind == "Pod":
        return core.Pod(metadata=m, spec=core.PodSpec(
            node_name="n0", priority=10, node_selector={"disk": "ssd"},
            tolerations=[core.Toleration(key="gpu", operator="Exists", effect="NoSchedule")],
            containers=[core.Container(name="main", image="busybox", resources={
                "requests": {"cpu": "500m", "memory": "1Gi"}},
                ports=[core.ContainerPort(container_port=8080)])]),
            status=core.PodStatus(phase="Running", conditions=[core.PodCondition(
                type="PodScheduled", status="True", reason="r", message="m")]))
    if kind == "Node":
        return core.Node(metadata=m, spec=core.NodeSpec(
            taints=[core.Taint(key="dedicated", value="batch", effect="NoSchedule")]),
            status=core.NodeStatus(allocatable={"cpu": "8", "memory": "16Gi"},
                                   capacity={"cpu": "8", "memory": "16Gi"}))
    if kind == "PriorityClass":
        return core.PriorityClass(metadata=m, value=1000, global_default=True)
    if kind == "ConfigMap":
        return core.ConfigMap(metadata=m, data={"k": "v"})
    if kind == "PersistentVolumeClaim":
        return core.PersistentVolumeClaim(metadata=m, spec={"storageClassName": "fast"},
                                          status={"phase": "Bound"})
    if kind == "Event":
        return core.Event(metadata=m, involved_object={"kind": "Pod", "name": "p0"},
                          type="Warning", reason="Unschedulable", message="0/1", count=3)
    if kind == "PodGroup":
        return sched.PodGroup(metadata=m, spec=sched.PodGroupSpec(
            min_member=2, queue="q0", min_resources={"cpu": "2"},
            priority_class_name="high"), status=sched.PodGroupStatus(
            phase=sched.POD_GROUP_INQUEUE, running=1))
    if kind == "Queue":
        return sched.Queue(metadata=m, spec=sched.QueueSpec(weight=4,
                                                            capability={"cpu": "32"}))
    if kind == "PodGroupV1alpha1":
        return scheme.PodGroupV1alpha1(metadata=m, spec=sched.PodGroupSpec(
            min_member=3, queue="q1"), status=sched.PodGroupStatus(
            phase=sched.POD_GROUP_INQUEUE, running=1))
    if kind == "QueueV1alpha1":
        return scheme.QueueV1alpha1(metadata=m, spec=scheme.QueueSpecV1alpha1(
            weight=2, capability={"cpu": "4"}), status=scheme.QueueStatusV1alpha1(
            pending=2, running=1))
    if kind == "Secret":
        return core.Secret(metadata=m, data={"token": "c2VjcmV0"}, type="kubernetes.io/ssh-auth")
    if kind == "Service":
        return core.Service(metadata=m, spec=core.ServiceSpec(
            selector={"app": "svc0"}, cluster_ip="None",
            ports=[core.ServicePort(name="ssh", port=22)]))
    if kind == "NetworkPolicy":
        return core.NetworkPolicy(metadata=m, spec={"podSelector": {"app": "web"}})
    if kind == "Job":
        return batch.Job(metadata=m, spec=batch.JobSpec(
            min_available=2, queue="q0", max_retry=5, priority_class_name="high",
            plugins={"ssh": [], "env": []}, tasks=[batch.TaskSpec(name="worker", replicas=2)]),
            status=batch.JobStatus(running=1, pending=1, version=4))
    if kind == "Command":
        return apis_bus.Command(metadata=m, action="AbortJob", target_object=core.OwnerReference(
            kind="Job", name="job0", uid="uid-job0", controller=True),
            reason="UserRequest", message="abort requested")
    raise AssertionError(kind)


def test_kinds_are_the_references_the_port_has():
    """The port's decode registry: every kind of the reference's, in the
    reference's order (the Job path's kinds since the controllers came);
    a kind neither has raises."""
    assert list(PORT.protocol.KINDS) == list(JAX.protocol.KINDS)
    assert set(PORT.protocol.KINDS) == {
        "Pod", "Node", "PriorityClass", "ConfigMap", "Secret", "Service",
        "PersistentVolumeClaim", "NetworkPolicy", "Event", "Job", "PodGroup", "Queue",
        "PodGroupV1alpha1", "QueueV1alpha1", "Command"}
    with pytest.raises(PORT.BusError, match="unknown kind"):
        PORT.protocol.decode_obj({"kind": "Deployment", "metadata": {"name": "x"}})


@pytest.mark.parametrize("kind", sorted(pkg("port").protocol.KINDS))
def test_every_kind_crosses_both_packages_losslessly(kind):
    """Port object → wire dict = the JAX object's wire dict; each
    package decodes the other's, and the round trip returns the object,
    through JSON bytes and through msgpack bytes."""
    port_obj, jax_obj = exemplar(PORT, kind), exemplar(JAX, kind)
    data = PORT.protocol.encode_obj(port_obj)
    assert data == JAX.protocol.encode_obj(jax_obj)
    assert JAX.protocol.decode_obj(data) == jax_obj
    assert PORT.protocol.decode_obj(JAX.protocol.encode_obj(jax_obj)) == port_obj
    for codec in ("json", "binary"):
        body = PORT.protocol.encode_payload({"object": data}, codec)
        assert body == JAX.protocol.encode_payload({"object": data}, codec)
        back = JAX.protocol.decode_payload(body, codec)["object"]
        assert PORT.protocol.decode_obj(back) == port_obj
        assert JAX.protocol.decode_obj(back) == jax_obj


def test_tables_equal_where_the_port_keeps_an_entry():
    pp, jp = PORT.protocol, JAX.protocol
    assert (pp.MAGIC, pp.VERSION, pp.MIN_VERSION, pp.CODEC_JSON, pp.CODEC_BINARY) == (
        jp.MAGIC, jp.VERSION, jp.MIN_VERSION, jp.CODEC_JSON, jp.CODEC_BINARY)
    names = [n for n in dir(jp) if n.startswith("T_")]
    assert {n: getattr(pp, n) for n in names} == {n: getattr(jp, n) for n in names}
    assert pp._HEADER.format == jp._HEADER.format
    assert pp.OP_VERSIONS == jp.OP_VERSIONS
    assert set(pp.ERRORS) == set(jp.ERRORS)
    assert pp.HAS_BINARY == jp.HAS_BINARY


@pytest.mark.parametrize("codec", ["json", "binary"])
def test_frames_are_byte_equal(codec):
    """``send_frame`` of the same payload writes the same bytes in both
    packages, and each package's ``recv_frame`` reads the other's."""
    payload = {"op": "commit_batch", "binds": [{"namespace": "ns", "name": "p0",
                                                "hostname": "n0"}], "cycle": 3,
               "pod_groups": [PORT.protocol.encode_obj(exemplar(PORT, "PodGroup"))]}
    frames = []
    for p in (PORT, JAX):
        a, b = socket.socketpair()
        try:
            p.protocol.send_frame(a, p.protocol.T_REQ, 42, payload, codec=codec)
            a.shutdown(socket.SHUT_WR)
            frames.append(b.recv(1 << 20))
        finally:
            a.close()
            b.close()
    assert frames[0] == frames[1]
    for reader in (PORT, JAX):
        a, b = socket.socketpair()
        try:
            a.sendall(frames[0])
            assert reader.protocol.recv_frame(b) == (reader.protocol.T_REQ, 42, payload)
        finally:
            a.close()
            b.close()


def test_errors_map_to_the_same_names():
    """A typed error crosses the wire by name: the port's payload is the
    reference's, and each package raises the other's by its own class."""
    for name in ("NotFoundError", "ConflictError", "AlreadyExistsError", "ApiError"):
        port_exc = getattr(PORT, name)("gone")
        assert PORT.protocol.error_payload(port_exc) == JAX.protocol.error_payload(
            getattr(JAX, name)("gone"))
        with pytest.raises(getattr(JAX, name), match="gone"):
            JAX.protocol.raise_error(PORT.protocol.error_payload(port_exc))
    leader = PORT.protocol.NotLeaderError("not leader", leader="tcp://a:1")
    assert PORT.protocol.error_payload(leader) == JAX.protocol.error_payload(
        JAX.protocol.NotLeaderError("not leader", leader="tcp://a:1"))


def test_url_parsing_and_records():
    pp, jp = PORT.protocol, JAX.protocol
    for url in ("tcp://10.0.0.1:7180", "localhost:99", "shm://h:1", "tcp://:5"):
        assert pp.parse_bus_url(url) == jp.parse_bus_url(url)
    for bad in ("http://x:1", "tcp://no-port"):
        with pytest.raises(ValueError):
            pp.parse_bus_url(bad)
    assert pp.parse_bus_endpoints("tcp://a:1, tcp://b:2") == jp.parse_bus_endpoints(
        "tcp://a:1, tcp://b:2")
    record = {"op": "create", "seq": 3, "object": {"kind": "Pod"}}
    for codec in (None, "json", "binary"):
        assert pp.encode_record(record, codec) == jp.encode_record(record, codec)
        assert pp.decode_record(jp.encode_record(record, codec)) == record


def test_server_splices_equal_the_references():
    """The watch-batch byte surgery: the port's spliced entries and batch
    bodies are the reference's bytes, in both codecs."""
    ps, js = PORT.server, JAX.server
    entry = {"seq": 42, "kind": "Pod", "event": "ADDED", "old": None,
             "new": PORT.protocol.encode_obj(exemplar(PORT, "Pod")), "ts": 1.5}
    port_cached, jax_cached = ps._CachedPayload(entry), js._CachedPayload(entry)
    assert port_cached.raw() == jax_cached.raw()
    assert port_cached.raw_bin() == jax_cached.raw_bin()
    json_parts = [ps._splice_watch_id(port_cached.raw(), w) for w in (7, 8)]
    assert json_parts == [js._splice_watch_id(jax_cached.raw(), w) for w in (7, 8)]
    assert json.loads(json_parts[0]) == dict(entry, watch_id=7)
    bin_parts = [ps._splice_watch_id_bin(port_cached.raw_bin(), w) for w in range(20)]
    assert bin_parts == [js._splice_watch_id_bin(jax_cached.raw_bin(), w) for w in range(20)]
    assert ps._batch_body_bin(bin_parts) == js._batch_body_bin(bin_parts)


def _entry(seq, name):
    return {"seq": seq, "kind": "ConfigMap", "event": "ADDED", "old": None,
            "new": {"kind": "ConfigMap", "metadata": {"name": name}, "data": {}}, "ts": 0.0}


@pytest.mark.parametrize("batch_watch", [True, False])
def test_writer_frames_equal_the_references(batch_watch):
    """Frames queued on a connection before its writer wakes: with
    ``watch_batch`` one T_WATCH_BATCH frame and the bookmark after it,
    without it one T_WATCH_EVENT frame each — the same bytes from both
    packages' writers."""
    streams = []
    for p in (PORT, JAX):
        s1, s2 = socket.socketpair()
        try:
            conn = p.server._Conn(s1, peer="test")
            conn.batch_watch = batch_watch
            for i in range(5):
                conn.outbound.put((p.protocol.T_WATCH_EVENT, 7, _entry(i + 1, f"c{i}")))
            conn.outbound.put((p.protocol.T_BOOKMARK, 7, {"seq": 5, "ts": 0.0}))
            writer = threading.Thread(target=conn.write_loop, daemon=True)
            writer.start()
            frames = [p.protocol.recv_frame(s2) for _ in range(2 if batch_watch else 6)]
            conn.kill()
            writer.join(timeout=5)
            streams.append(frames)
        finally:
            s1.close()
            s2.close()
    assert streams[0] == streams[1]
    if batch_watch:
        (mtype, _, payload), (last, _, _) = streams[0]
        assert mtype == PORT.protocol.T_WATCH_BATCH and last == PORT.protocol.T_BOOKMARK
        assert [e["seq"] for e in payload["events"]] == [1, 2, 3, 4, 5]
    else:
        assert [f[0] for f in streams[0]] == [PORT.protocol.T_WATCH_EVENT] * 5 + [
            PORT.protocol.T_BOOKMARK]
