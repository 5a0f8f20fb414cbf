"""The port's on-demand profiler against the JAX package's, on the CPU.

Host mode is the reference's sampling profiler: both packages' captures
of the same busy thread are held to the same contract (collapsed-stack
lines, the thread's marker frame present, distinct file names, the
bounded window, ``ProfileBusy`` and a bad mode), and so are the service
op and the REST route. Device mode differs on purpose: the port traces
the card with ``torch.profiler`` and, without CUDA, raises rather than
profile the CPU in the card's place (the reference traces whatever JAX
runs on). The card's case is the ``gpu``-marked one in
``tests/test_torch_cuda.py``. Mirrors ``tests/test_profiling.py``.
"""

import os
import threading
import time

import pytest

from test_torch_agent import PORT, both, make_agent, svc_client


def busy(marker_name):
    """A thread whose stack carries ``marker_name``; returns (start,
    stop)."""
    stop = threading.Event()

    def loop():
        while not stop.is_set():
            sum(range(200))
            time.sleep(0.001)

    loop.__code__ = loop.__code__.replace(co_name=marker_name)
    t = threading.Thread(target=loop, daemon=True)
    t.start()

    def done():
        stop.set()
        t.join(timeout=5)

    return done


def collapsed(path):
    rows = []
    for line in open(path):
        stack, count = line.rstrip("\n").rsplit(" ", 1)
        rows.append((stack, int(count)))
    return rows


def test_host_profile_samples_running_threads_and_format():
    def run(P, tmp):
        done = busy("busy_loop_marker_fn")
        try:
            p = P.profiling.Profiler()
            r1 = p.capture(tmp, seconds=0.4, mode="host", hz=200)
            r2 = p.capture(tmp, seconds=0.2, mode="host", hz=200)
        finally:
            done()
        rows = collapsed(r1["path"])
        return {"mode": r1["mode"], "keys": sorted(r1),
                "many": r1["samples"] > 10,
                "marker": any("busy_loop_marker_fn" in s for s, _ in rows),
                "distinct": r1["path"] != r2["path"],
                "sum": sum(c for _, c in rows) >= r1["samples"],
                "stacks": r1["distinct_stacks"] == len(rows) >= 1,
                "seconds": [r1["seconds"], r2["seconds"]],
                "dir": os.path.dirname(r1["path"]) == tmp,
                "hint": r1["hint"]}

    got = both(run)
    assert got["marker"] and got["many"] and got["distinct"]


def test_window_is_bounded():
    def run(P, tmp):
        p = P.profiling.Profiler()
        return [p.capture(tmp, seconds=0.0, mode="host")["seconds"],
                p.capture(tmp, seconds=-3, mode="host")["seconds"]]

    assert both(run) == [0.1, 0.1]


def test_busy_and_bad_mode_surface_cleanly():
    def run(P, tmp):
        p = P.profiling.Profiler()
        finished = threading.Event()

        def long_capture():
            p.capture(tmp, seconds=0.5, mode="host")
            finished.set()

        t = threading.Thread(target=long_capture, daemon=True)
        t.start()
        deadline = time.monotonic() + 5
        while p._active is None and time.monotonic() < deadline:
            time.sleep(0.01)
        out = [p._active]
        with pytest.raises(P.profiling.ProfileBusy) as e:
            p.capture(tmp, seconds=0.1, mode="host")
        out.append(str(e.value))
        assert finished.wait(timeout=5)
        t.join(timeout=5)
        with pytest.raises(ValueError) as e:
            p.capture(tmp, seconds=0.1, mode="heap")
        out += [str(e.value), p._active]
        return out

    assert both(run)[0] == "host"


def test_device_mode_raises_without_cuda(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = PORT.profiling.Profiler()
    with pytest.raises(RuntimeError, match="needs CUDA"):
        p.capture(PORT.profiling.default_profile_dir(), seconds=0.1,
                  mode="device")
    # the failed capture released the profiler
    assert p._active is None


def test_default_dir_is_under_tmpdir(monkeypatch, tmp_path):
    import tempfile

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", None)
    assert PORT.profiling.default_profile_dir().startswith(str(tmp_path))


def test_service_op_profile_and_busy():
    """The ``{"op": "profile"}`` face of both packages' services: a host
    capture, a bad mode, a busy profiler — answers compared."""

    def run(P, tmp):
        sock = os.path.join(tmp, "svc.sock")
        agent = make_agent(P, tmp, socket_path=sock)
        client = svc_client(P, sock)
        try:
            r = client.call({"op": "profile", "seconds": 0.2,
                             "mode": "host",
                             "out": os.path.join(tmp, "prof")})
            out = [r["mode"], os.path.exists(r["path"]), r["samples"] > 0,
                   client.call({"op": "profile", "mode": "heap"})]
            P.profiling.PROFILER._active = "host"
            try:
                out.append(client.call({"op": "profile", "seconds": 0.1,
                                        "mode": "host",
                                        "out": os.path.join(tmp, "p")}))
            finally:
                P.profiling.PROFILER._active = None
            return out
        finally:
            client.close()
            agent.stop()

    got = both(run)
    assert got[:3] == ["host", True, True]
    assert "in progress" in got[-1]["error"]


def test_service_device_mode_without_cuda_is_an_error(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    import tempfile

    with tempfile.TemporaryDirectory(prefix="pf") as tmp:
        sock = os.path.join(tmp, "svc.sock")
        agent = make_agent(PORT, tmp, socket_path=sock)
        client = svc_client(PORT, sock)
        try:
            r = client.call({"op": "profile", "seconds": 0.1,
                             "mode": "device", "out": tmp})
            assert "needs CUDA" in r["error"]
        finally:
            client.close()
            agent.stop()
