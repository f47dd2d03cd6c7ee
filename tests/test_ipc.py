"""IPC/remote-backend tests: framed transport, full Backend contract over a
spawned worker subprocess, error propagation, end-to-end engine execution
over IPC (reference: rtc_ipc.cc cs_test_* self-spawning pattern —
multi-process tested by actually forking workers in-test, SURVEY §4.7).
"""

import os
import socket
import threading

import numpy as np
import pytest

from boda_tpu.backend.iface import RtcFuncCall, make_backend
from boda_tpu.core.dims import NDA, Dims
from boda_tpu.core.error import RtErr
from boda_tpu.ops.op_base import OpBase
from boda_tpu.ops.pallas.sgemm import make_sgemm_op
from boda_tpu.ops.registry import Codegen
from boda_tpu.parallel.transport import Stream, make_stream


def test_stream_framing_socketpair():
    a, b = socket.socketpair()
    sa, sb = Stream(sock=a), Stream(sock=b)
    sa.write_frame(b"hello")
    sa.write_frame(b"" )
    sa.write_frame(b"x" * 100000)
    assert sb.read_frame() == b"hello"
    assert sb.read_frame() == b""
    assert len(sb.read_frame()) == 100000
    sa.close()
    sb.close()


def test_stream_tcp():
    import random
    port = random.randint(20000, 40000)
    got = {}

    def server():
        s = make_stream(f"tcp-listen:{port}", is_server=True)
        got["msg"] = s.read_frame()
        s.write_frame(b"pong")
        s.close()

    t = threading.Thread(target=server)
    t.start()
    import time
    time.sleep(0.2)
    c = make_stream(f"tcp:127.0.0.1:{port}")
    c.write_frame(b"ping")
    assert c.read_frame() == b"pong"
    t.join()
    assert got["msg"] == b"ping"
    c.close()


def test_bad_transport_addr():
    with pytest.raises(RtErr, match="unknown transport method"):
        make_stream("bogus:1:2")


@pytest.fixture()
def ipc_be():
    be = make_backend("(be=ipc,worker_be=interp)")
    be.init()
    yield be
    be.quit_worker()


def test_ipc_backend_contract(ipc_be):
    be = ipc_be
    assert be.get_plat_tag() == "ipc:interp:numpy"
    d = Dims.make(y=4, x=8)
    be.create_var_with_dims("v", d)
    assert be.var_exists("v") and be.get_var_dims("v") == d
    x = np.arange(32, dtype=np.float32).reshape(4, 8)
    be.copy_nda_to_var("v", NDA(d, x))
    np.testing.assert_array_equal(be.copy_var_to_nda("v").v, x)
    be.create_var_with_dims_as_reshaped_view_of_var("vf", Dims.make(n=32), "v")
    np.testing.assert_array_equal(be.copy_var_to_nda("vf").v, x.reshape(-1))
    be.release_var("vf")
    be.release_var("v")
    # worker-side errors propagate with stable text
    with pytest.raises(RtErr, match="ipc worker error"):
        be.copy_var_to_nda("nonexistent")


def test_ipc_run_sgemm(ipc_be):
    be = ipc_be
    cg = Codegen(be)
    op = make_sgemm_op(32, 32, 32)
    for v in ("a", "b", "c"):
        be.create_var_with_dims(v, op.get_dims(v))
    rng = np.random.RandomState(0)
    a = rng.randn(32, 32).astype(np.float32)
    bm = rng.randn(32, 32).astype(np.float32)
    be.copy_ndas_to_vars({"a": NDA(op.get_dims("a"), a),
                          "b": NDA(op.get_dims("b"), bm)})
    cid = cg.gen_and_run(op, {"a": "a", "b": "b", "c": "c"})
    be.finish_and_sync()
    assert be.get_dur(cid, cid) >= 0
    # tiled accumulation order differs from numpy's @ — mrd-style tolerance
    np.testing.assert_allclose(be.copy_var_to_nda("c").v, a @ bm, rtol=1e-4)


def test_rtc_test_over_ipc(capsys):
    from boda_tpu.core.has_main import create_and_run_has_main
    create_and_run_has_main("(mode=cs_test_master,worker_be=interp,n=256)",
                            global_vars={})
    out = capsys.readouterr().out
    assert "rtc_test PASSED plat=ipc:interp:numpy" in out
    assert "cs_test_master PASSED" in out


def test_ipc_tcp_remote_worker():
    """TCP transport end-to-end: worker listens (the manual-launch /
    remote-machine workflow, rtc_ipc.cc:98-140 print-command path), master
    connects by address — the 'drive a remote GPU host' pattern."""
    import random
    import subprocess
    import sys
    import time

    port = random.randint(20000, 40000)
    proc = subprocess.Popen(
        [sys.executable, "-m", "boda_tpu", "ipc_compute_worker",
         f"--boda-parent-addr=tcp-listen:{port}", "--rtc=interp"])
    try:
        deadline = time.time() + 120
        be = None
        while time.time() < deadline:
            try:
                be = make_backend(f"(be=ipc,boda_parent_addr=tcp:127.0.0.1:{port})")
                be.init()
                break
            except RtErr:
                time.sleep(1.0)
        assert be is not None and be._initialized, "worker never came up"
        assert be.get_plat_tag() == "ipc:interp:numpy"
        d = Dims.make(y=2, x=3)
        be.create_var_with_dims("v", d)
        x = np.arange(6, dtype=np.float32).reshape(2, 3)
        be.copy_nda_to_var("v", NDA(d, x))
        np.testing.assert_array_equal(be.copy_var_to_nda("v").v, x)
        be.quit_worker()
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()


def test_ipc_spawn_str_worker():
    """spawn_str launches the worker via an expanded shell command with
    %(addr)/%(port) pointing at the master's pre-bound TCP listener (the
    reference's adb/ssh worker-launch pattern, rtc_ipc.cc:290)."""
    import sys
    # %%(addr): the config layer expands %(var) at init, so spawn strings
    # double the % to defer expansion to spawn time (master listener addr)
    spawn = (f"{sys.executable} -m boda_tpu ipc_compute_worker "
             f"--boda-parent-addr=%%(addr) --rtc=interp")
    be = make_backend({"be": "ipc", "spawn_str": spawn})
    be.init()
    try:
        assert be.get_plat_tag() == "ipc:interp:numpy"
        d = Dims.make(y=2, x=2)
        be.create_var_with_dims("v", d)
        x = np.arange(4, dtype=np.float32).reshape(2, 2)
        be.copy_nda_to_var("v", NDA(d, x))
        np.testing.assert_array_equal(be.copy_var_to_nda("v").v, x)
    finally:
        be.quit_worker()
    assert be._proc.returncode == 0
