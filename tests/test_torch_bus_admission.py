"""Remote admission over the bus, the port against the JAX package.

A webhook client of either package (``RemoteAPIServer.register_admission``)
against a bus server of either package: the server forwards each create
of the registered kind as an admission-review frame, the client's hooks
mutate or deny it, and the verdict decides the write; the review frames
and the verdict frames are byte-equal across packages; a reviewer on the
very connection that submits (one client for webhook and submitter)
answers at once; after the server restarts, the client's resync
registers it again.  ``tests/test_bus_e2e.py``'s two cases run on the
port as on the JAX package (``tests.torch_mirror``; the multi-process
one is ``slow``, as its reference is), their bindings equal.  Every
server binds port 0 and is stopped, and every client closed.
"""

from __future__ import annotations

import functools
import time

import pytest

import chip_smoke
from tests import torch_mirror
from tests.torch_bus_helpers import (  # noqa: F401 — fixtures
    cm, cpu_actions, one_torch_thread, pair, PAIRS, Pair, shm_env, wait)


def registered(p, kind: str = "ConfigMap") -> bool:
    """The pair's server forwards reviews of ``kind`` creates."""
    return bool(p.server._admission.get((kind, "CREATE")))


def hook_for(c):
    """A webhook of package ``c``: denies "forbidden", stamps the rest."""
    def hook(operation, obj):
        if obj.metadata.name == "forbidden":
            raise c.AdmissionError("name is forbidden")
        obj.data["admitted-by"] = "hook"
        return obj

    return hook


#: each test below over every {port, JAX client} x {port, JAX server}
over_pairs = pytest.mark.parametrize("pair", PAIRS, indirect=True, ids=lambda p: "-".join(p))


@over_pairs
def test_admission_mutate_and_deny(pair):
    reviewer = pair.new_client()
    c = pair.c
    reviewer.register_admission("ConfigMap", "CREATE", hook_for(c))
    assert wait(lambda: registered(pair), 5)
    pair.client.create(cm(c, "fine"))
    assert pair.store.get("ConfigMap", "ns", "fine").data["admitted-by"] == "hook"
    with pytest.raises(c.ApiError, match="forbidden") as err:
        pair.client.create(cm(c, "forbidden"))
    assert type(err.value).__name__ == "AdmissionError"
    assert pair.store.get("ConfigMap", "ns", "forbidden") is None


@over_pairs
def test_admission_review_on_the_same_connection(pair):
    """One connection is the webhook and the submitter, and its hook
    reads back through that connection mid-review: the verdict comes at
    once, not after the server's admission timeout."""
    client, c = pair.client, pair.c

    def hook(operation, obj):
        assert client.get("ConfigMap", "ns", "never") is None
        if obj.metadata.name == "bad":
            raise c.AdmissionError("nope")
        obj.data["reviewed"] = "yes"
        return obj

    client.register_admission("ConfigMap", "CREATE", hook)
    assert wait(lambda: registered(pair), 5)
    start = time.monotonic()
    client.create(cm(c, "good"))
    assert time.monotonic() - start < 3.0, "review round-trip stalled"
    assert pair.store.get("ConfigMap", "ns", "good").data["reviewed"] == "yes"
    with pytest.raises(c.ApiError, match="nope"):
        client.create(cm(c, "bad"))


@over_pairs
def test_registration_replayed_after_server_restart(pair):
    """A webhook client registers again after its connection comes back
    to a restarted server (the resync), and a closed connection's
    registration is dropped by the server."""
    reviewer = pair.new_client()
    c = pair.c
    # both connections through their set-up (the codec hello; with no
    # webhook and no watch yet the connection thread then goes idle)
    # before the webhook registers and the server restarts: a JAX client
    # whose set-up calls (the hello, a webhook's leader check and
    # re-registration) a restart cuts waits out each call's 5 s timeout;
    # the port's client fails them at once (tests/test_torch_bus_resilience.py)
    want = "binary" if c.protocol.HAS_BINARY and pair.s.protocol.HAS_BINARY else "json"
    assert wait(lambda: reviewer.codec == pair.client.codec == want, 5)
    reviewer.register_admission("ConfigMap", "CREATE", hook_for(c))
    assert wait(lambda: registered(pair), 5)
    pair.restart_server()
    assert wait(lambda: registered(pair), 10), "the webhook never registered again"

    def denies() -> bool:
        """A semantic probe (``cmd.local_up.wait_for_admission``'s): the
        webhook refuses "forbidden" once its registration holds; a probe
        let through while the connections settle is deleted."""
        try:
            pair.client.create(cm(c, "forbidden"))
        except c.AdmissionError:
            return True
        except c.ApiError:
            return False
        pair.client.delete("ConfigMap", "ns", "forbidden")
        return False

    assert wait(denies, 10, 0.1), "the webhook never answered again"
    pair.client.create(cm(c, "after"))
    assert pair.store.get("ConfigMap", "ns", "after").data["admitted-by"] == "hook"
    reviewer.close()
    assert wait(lambda: not registered(pair), 10), "a closed webhook stayed registered"
    pair.client.create(cm(c, "forbidden"))  # no webhook: admitted as it is
    assert "admitted-by" not in pair.store.get("ConfigMap", "ns", "forbidden").data


def review_frames(name: str, monkeypatch) -> list:
    """The admission frames (T_ADMIT_REQ from the server, T_ADMIT_RESP
    from the webhook) of package ``name``'s client and server for one
    admitted and one denied create, as sent on the wire."""
    from volcano_tpu.bus import protocol as jax_protocol
    from volcano_tpu_torch.bus import protocol as port_protocol

    proto = port_protocol if name == "port" else jax_protocol
    frames = []
    real = proto.send_frame_raw

    def send_frame_raw(sock, mtype, corr_id, body, *args, **kwargs):
        if mtype in (proto.T_ADMIT_REQ, proto.T_ADMIT_RESP):
            frames.append((mtype, corr_id, bytes(body)))
        return real(sock, mtype, corr_id, body, *args, **kwargs)

    monkeypatch.setattr(proto, "send_frame_raw", send_frame_raw)
    p = Pair(name, name)
    try:
        c = p.c
        reviewer = p.new_client()
        # a connection frames JSON until its codec hello comes back
        codec = proto.CODEC_BINARY if proto.HAS_BINARY else proto.CODEC_JSON
        assert wait(lambda: reviewer.codec == p.client.codec == codec, 5)
        reviewer.register_admission("ConfigMap", "CREATE", hook_for(c))
        assert wait(lambda: registered(p), 5)
        p.client.create(cm(c, "fine", data={"k": "v"}))
        with pytest.raises(c.ApiError):
            p.client.create(cm(c, "forbidden"))
    finally:
        p.close()
    return frames


def test_review_frames_byte_equal(monkeypatch):
    port = review_frames("port", monkeypatch)
    ref = review_frames("jax", monkeypatch)
    assert len(port) == 4
    assert port == ref


def test_min_available_denial_is_the_jax_text():
    """``vtctl job run`` of a Job whose minAvailable exceeds its replicas,
    against a store with each package's webhooks, prints
    ``chip_smoke.MIN_AVAILABLE_DENIAL`` (what ``phase_local_up`` expects
    of the admission child) in both packages."""
    import io
    from importlib import import_module

    for root in ("volcano_tpu", "volcano_tpu_torch"):
        core = import_module(root + ".apis.core")
        scheduling = import_module(root + ".apis.scheduling")
        api = import_module(root + ".client").APIServer()
        import_module(root + ".admission").register_webhooks(api)
        api.create(scheduling.Queue(metadata=core.ObjectMeta(name="default", namespace="")))
        buf = io.StringIO()
        rc = import_module(root + ".cli.vtctl").main(
            ["job", "run", "-N", "too-small", "-r", "3", "--min", "4"], api=api, out=buf)
        assert (rc, buf.getvalue()) == (1, f"error: {chip_smoke.MIN_AVAILABLE_DENIAL}\n"), root
        assert api.get("Job", "default", "too-small") is None


# ---- tests/test_bus_e2e.py on both packages ----

REL = "tests/test_bus_e2e.py"
CASES = torch_mirror.cases(torch_mirror.load(REL, "jax"))


def _bindings(stores) -> list:
    return [sorted((p.metadata.name, p.spec.node_name) for p in s.list("Pod")) for s in stores]


@pytest.mark.parametrize("case", [pytest.param(c, marks=[getattr(pytest.mark, m) for m in marks])
                                  for c, marks in CASES])
def test_bus_e2e_case_equal_on_both_packages(case, tmp_path, cpu_actions, monkeypatch,  # noqa: F811
                                              shm_env):
    """Each case on the port (its scheduler, in process or as children,
    on the CPU instance of gpu-allocate), then on the JAX package; the
    stores the runs built hold the same bindings."""
    import volcano_tpu_torch.cmd.local_up as local_up

    monkeypatch.setattr(local_up, "multiproc_up",
                        functools.partial(local_up.multiproc_up, device="cpu"))
    port = torch_mirror.load(REL, "port")
    torch_mirror.run_case(port, case, tmp_path / "port")
    ref = torch_mirror.load(REL, "jax")
    torch_mirror.run_case(ref, case, tmp_path / "jax")
    assert _bindings(port.STORES) == _bindings(ref.STORES)


def test_every_bus_e2e_case_is_mirrored():
    assert [c for c, _ in CASES] == [
        "test_control_plane_over_bus_binds_identically",
        "test_multiprocess_deployment_with_scheduler_sigkill_takeover"]
