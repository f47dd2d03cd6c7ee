"""chip_smoke.py at a tiny size on the CPU: every phase's path and checks
run here (numbers come only from the card), the script refuses a machine
without a GPU, and the four-card phase runs on virtual CPU devices."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

import chip_smoke as cs

ROOT = Path(__file__).resolve().parents[1]
TINY = cs.Size(fwd_batch=2, default_batch=2, ref_imgs=1, hw=224,
               train_batch=2, train_hw=64, train_steps=3,
               serve_model="mini", mesh_batch=4)


@pytest.fixture(scope="module")
def ctx():
    c = cs.Ctx(TINY, "cpu")
    cs.phase_forward(c)
    return c


def test_phase_forward_checks_bf16_f32_and_ref(ctx):
    v = ctx.vals
    assert v["p_bf"].shape == (2, cs.NUM_CLASSES)
    assert v["p_32"].shape == (2, cs.NUM_CLASSES)
    assert (v["p_bf"].argmax(1) == v["p_32"].argmax(1)).all()


def test_phase_default(ctx):
    assert "tune=() top1_agree=1.0" in cs.phase_default(ctx)


def test_phase_int8(ctx):
    msg = cs.phase_int8(ctx)
    assert "sites=33" in msg and "int8_conv_lines=" in msg


def test_phase_train(ctx):
    assert "grad_rel_l2=" in cs.phase_train(ctx)


def test_phase_serve(ctx):
    msg = cs.phase_serve(ctx)
    assert msg.count("top-2:") == 3


def test_phase_backend(ctx):
    msg = cs.phase_backend(ctx)
    assert "plat=xla:cpu:" in msg and "device total:" in msg


def test_phase_failure_is_reported_not_swallowed(capsys):
    def bad(_ctx):
        cs.check(False, "deliberate miss")
    failed = cs.run_phases(cs.Ctx(TINY, "cpu"), [("bad", bad)])
    assert failed == ["bad"]
    assert "phase 1 bad: FAILED" in capsys.readouterr().out


def test_dependent_phase_fails_without_phase_one():
    with pytest.raises(cs.SmokeFail, match="needs phase 1"):
        cs.phase_default(cs.Ctx(TINY, "cpu"))


def test_main_refuses_a_machine_without_gpu(capsys):
    assert cs.main([]) == 1
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_script_alone_exits_nonzero(tmp_path):
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_multichip_phase_on_virtual_devices():
    import jax
    assert len(jax.devices()) >= 4
    msg = cs.phase_multichip(cs.Ctx(cs.Size(hw=32, mesh_batch=4), "cpu"))
    assert "mesh=(2,2)" in msg and "mrd=" in msg


def test_result_line_reports_devices_as_jax_does():
    import types
    devs = [types.SimpleNamespace(platform="gpu",
                                  device_kind="NVIDIA H100 80GB HBM3")] * 4
    d = json.loads(cs.result_line(devs))
    assert d == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}
