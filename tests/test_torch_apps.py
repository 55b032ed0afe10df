"""Port parity: the host layer of the three-process deployment.

- Every JAX-free file the port copies (the rest of the LTE-side ``stack/``,
  ``utils/{io,log,metrics,sys_metrics,checkpoint,crash_handler}``,
  ``config``, ``runtime/tasks``, ``apps/srsepc`` and the two example
  configs) equals its JAX-package source once ``srsran_4g_tpu.`` is
  rewritten to ``srsran_4g_tpu_torch.``.
- ``config.load_config`` on both example files and with overrides: the
  dataclass trees equal the JAX package's field for field.
- ``runtime/tasks`` on the scenarios of ``tests/test_runtime_tasks.py``:
  the same traces in both packages.
- ``runtime/native`` (the port's own ctypes bindings to the same
  ``native/runtime.cc``): ring buffer and bridge loopback byte-identical to
  what the JAX bindings read on the same samples, the two packages' bridge
  ends talking to each other, and the library built once when several
  processes load it at once on a fresh tree.
- ``runtime/radio`` on the null, file and bridge devices: the same samples,
  timestamps and error callbacks as the JAX radio, the resampled ones within
  atol 1e-5.
- GTP-U pack/unpack byte-identical to JAX's.
- The apps: ``--tdd`` with TM 3/4 is a usage error, ``--tm``/``--cc``
  follow the config file when not given, and without a card the PHY apps
  and ``tools/phy_e2e`` exit with ``resolve_device``'s error.
"""

import argparse
import dataclasses
import importlib
import re
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from srsran_4g_tpu import config as j_config
from srsran_4g_tpu.runtime import native as j_native, radio as j_radio, tasks as j_tasks
from srsran_4g_tpu.stack import gtpu as j_gtpu
from srsran_4g_tpu_torch import config as t_config
from srsran_4g_tpu_torch.runtime import native as t_native, radio as t_radio, tasks as t_tasks
from srsran_4g_tpu_torch.stack import gtpu as t_gtpu
from srsran_4g_tpu_torch.tools.three_process import free_base

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
COPIED = (*(f"stack/{m}.py" for m in ("gtpu", "gtpc", "mbms_gw", "x2", "e2", "e2ap_per",
                                      "nas_eps_codec")),
          *(f"utils/{m}.py" for m in ("io", "log", "metrics", "sys_metrics", "checkpoint",
                                      "crash_handler")),
          "config.py", "runtime/tasks.py", "apps/srsepc.py", "apps/enb.conf.example",
          "apps/ue.conf.example")


@pytest.mark.parametrize("path", COPIED)
def test_copied_file_equals_jax_source(path):
    jax_src = (REPO / "srsran_4g_tpu" / path).read_text()
    port_src = (REPO / "srsran_4g_tpu_torch" / path).read_text()
    assert port_src == re.sub(r"\bsrsran_4g_tpu\.", "srsran_4g_tpu_torch.", jax_src)
    if path.endswith(".py"):
        name = "srsran_4g_tpu_torch." + path[:-3].replace("/", ".")
        assert importlib.import_module(name).__file__.endswith(f"srsran_4g_tpu_torch/{path}")


def _tree(cfg) -> tuple:
    """A config tree as (class name, fields) pairs, recursively."""
    if dataclasses.is_dataclass(cfg):
        return type(cfg).__name__, tuple((f.name, _tree(getattr(cfg, f.name)))
                                         for f in dataclasses.fields(cfg))
    return cfg


@pytest.mark.parametrize("name,overrides", [
    ("enb.conf.example", []), ("ue.conf.example", []),
    ("enb.conf.example", ["cell.tm=4", "cell.nof_ports=2", "phy.pdsch_max_its=6",
                          "rat.eutra.dl_earfcn=2850", "channel.dl.awgn.snr_db=12"])])
def test_load_config_matches_jax(name, overrides):
    t_cfg = t_config.load_config(str(REPO / "srsran_4g_tpu_torch" / "apps" / name), overrides)
    j_cfg = j_config.load_config(str(REPO / "srsran_4g_tpu" / "apps" / name), overrides)
    assert _tree(t_cfg) == _tree(j_cfg)
    assert t_config.to_dict(t_cfg) == j_config.to_dict(j_cfg)


# --- runtime/tasks: the scenarios of tests/test_runtime_tasks.py, traced --------


def _timers(T):
    s, out = T.TaskScheduler(), []
    s.timers.start(5, lambda: out.append(("a", s.timers.now_ms)))
    tid = s.timers.start(3, lambda: out.append(("b", s.timers.now_ms)))
    s.timers.start(2, lambda: out.append(("c", s.timers.now_ms)))
    s.timers.stop(tid)
    for _ in range(6):
        s.tick(1)
    return out


def _multiqueue(T):
    s, out = T.TaskScheduler(), []
    p1, p2 = s.make_port(), s.make_port()
    for i in range(3):
        p1.push(lambda i=i: out.append(("p1", i)))
        p2.push(lambda i=i: out.append(("p2", i)))
    s.defer(lambda: out.append(("int", 0)))
    return out, s.run_pending()


def _semaphore(T):
    sem = T.TtiSemaphore()
    for t in (10, 11, 12, 13):
        sem.push(t)
    done, out = {12: "c", 10: "a"}, []
    out.append(sem.commit_ready(done))
    done[11] = "b"
    out.append(sem.commit_ready(done))
    done[13] = "d"
    out.append(sem.commit_ready(done))
    return out


def _procs(T):
    steps = []

    def connection_proc():
        steps.append("start")
        rsp = yield
        steps.append(f"got:{rsp}")
        ok = yield
        steps.append("done")
        return ok == "ok"

    def failing():
        yield
        return False

    p, results = T.Proc(connection_proc), []
    p.launch()
    trace = [(p.state.name, p.is_busy, list(steps))]
    p.trigger("setup")
    p.then(results.append)
    p.trigger("ok")
    trace.append((p.state.name, p.is_busy, list(steps), results))
    q = T.Proc(failing)
    q.launch()
    q.trigger("x")
    return trace + [q.state.name]


def _fsm(T):
    entered = []
    fsm = T.Fsm("IDLE")
    fsm.add("IDLE", "connect", "CONNECTING")
    fsm.add("CONNECTING", "setup", "CONNECTED")
    fsm.add("CONNECTED", "rlf", "IDLE")
    fsm.on_enter("CONNECTED", lambda: entered.append("conn"))
    fired = [fsm.fire(e) for e in ("connect", "bogus", "setup", "rlf")]
    return fired, fsm.state, fsm.history, entered


@pytest.mark.parametrize("scenario", [_timers, _multiqueue, _semaphore, _procs, _fsm],
                         ids=lambda f: f.__name__[1:])
def test_tasks_traces_match_jax(scenario):
    assert scenario(t_tasks) == scenario(j_tasks)


# --- runtime/native ------------------------------------------------------------


def _samples(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)


def test_ring_buffer_matches_jax():
    x, big = _samples(10), _samples(900, 1)
    reads = []
    for native in (t_native, j_native):
        rb, got = native.RingBuffer(1000), []
        got.append(rb.write(x))
        got += [rb.size, rb.read(6).tobytes(), rb.read(10).tobytes()]
        got += [rb.write(big), rb.write(big), rb.read(1000).tobytes()]
        reads.append(got)
    assert reads[0] == reads[1]
    assert reads[0][2] == x[:6].tobytes() and reads[0][3] == x[6:].tobytes()


def _loopback(tx_native, rx_native, data):
    """Send ``data`` in two frames through one package's bridge TX and read
    it in odd chunks through one package's bridge RX."""
    port = free_base(0)
    tx = tx_native.IqBridgeTx(port)
    got = {}

    def rx_side():
        rx = rx_native.IqBridgeRx("127.0.0.1", port)
        got["data"] = b"".join(rx.read(n).tobytes() for n in (1000, 3000, 96))
        got["count"] = rx.sample_count
        rx.close()

    t = threading.Thread(target=rx_side)
    t.start()
    tx.accept()
    tx.send(data[:2048])
    tx.send(data[2048:])
    t.join(timeout=30)
    tx.close()
    assert not t.is_alive()
    return got


def test_bridge_loopback_matches_jax():
    data = _samples(4096)
    port = _loopback(t_native, t_native, data)
    assert port == _loopback(j_native, j_native, data)
    assert port == {"data": data.tobytes(), "count": 4096}
    # each package's end talks to the other's
    assert _loopback(t_native, j_native, data) == port
    assert _loopback(j_native, t_native, data) == port


def test_bridge_rx_connects_to_a_late_tx():
    """The RX end tries before the TX end has bound its port: it connects
    once the port is bound, within its timeout."""
    port, data, got = free_base(0), _samples(256), {}

    def rx_side():
        rx = t_native.IqBridgeRx("127.0.0.1", port, timeout_ms=20000)
        got["data"] = rx.read(256).tobytes()
        rx.close()

    t = threading.Thread(target=rx_side)
    t.start()
    time.sleep(0.3)
    tx = t_native.IqBridgeTx(port)
    tx.accept()
    tx.send(data)
    t.join(timeout=30)
    tx.close()
    assert not t.is_alive() and got["data"] == data.tobytes()


_LOAD_AT = """
import ctypes, importlib.util, sys, time
from pathlib import Path
spec = importlib.util.spec_from_file_location("native", sys.argv[1])
native = importlib.util.module_from_spec(spec)
spec.loader.exec_module(native)
d = Path(sys.argv[2])
time.sleep(max(0.0, float(sys.argv[3]) - time.time()))
built = native.build_library(d, d / "build" / "native.lock")
lib = native._bind(ctypes.CDLL(str(d / native.LIB_NAME)))
h = lib.rt_rb_create(16)
print(int(built), lib.rt_rb_space(h))
"""


def test_native_builds_once_when_processes_load_at_once(tmp_path):
    """Four processes load the runtime from a fresh copy of ``native/`` at
    the same moment: one runs the Makefile, the others wait on the file
    lock and load what it built."""
    for name in ("Makefile", "runtime.cc"):
        shutil.copy(REPO / "native" / name, tmp_path / name)
    start = time.time() + 1.0
    procs = [subprocess.Popen([sys.executable, "-c", _LOAD_AT, t_native.__file__,
                               str(tmp_path), str(start)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert sorted(outs) == ["0 16\n"] * 3 + ["1 16\n"], outs
    assert (tmp_path / t_native.LIB_NAME).exists()
    assert t_native.LOCK_PATH.parent == REPO / "build"


# --- runtime/radio -------------------------------------------------------------


def _radio_run(R, args, **kw):
    """Read three buffers (a drop injected before the second), write one
    through the rate conversion; the samples as numpy, the timestamps and
    the error callbacks."""
    radio = R.Radio(args, **kw)
    errors = []
    radio.error_handler = errors.append
    out = []
    for i, n in enumerate((2048, 2048, 4096)):
        if i == 1:
            radio.inject_drop(100)
        x, ts = radio.rx_now(n)
        out.append((np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x), ts))
    radio.tx(_samples(2048, 3))
    radio.close()
    return out, [e.name for e in errors]


@pytest.mark.parametrize("phy,dev", [(2.0, 1.0), (1.0, 2.0), (1.0, 1.0)],
                         ids=["up", "down", "same"])
def test_radio_file_device_matches_jax(tmp_path, phy, dev):
    x = np.exp(2j * np.pi * 0.01 * np.arange(4096)).astype(np.complex64) + _samples(4096) * 0.1
    src = tmp_path / "cap.dat"
    x.tofile(src)
    got = {}
    for R, key, kw in ((t_radio, "port", {"device": "cpu"}), (j_radio, "jax", {})):
        sink = tmp_path / f"{key}.dat"
        got[key] = _radio_run(R, R.RadioArgs(device="file", rx_path=str(src), tx_path=str(sink),
                                             phy_srate_hz=phy, dev_srate_hz=dev), **kw)
        got[key] += (np.fromfile(sink, np.complex64),)
    (t_rx, t_err, t_tx), (j_rx, j_err, j_tx) = got["port"], got["jax"]
    assert t_err == j_err and "OVERFLOW" in t_err and "UNDERFLOW" in t_err
    for (a, ta), (b, tb) in zip(t_rx, j_rx):
        assert ta == tb and a.dtype == np.complex64 and a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    assert t_tx.shape == j_tx.shape
    np.testing.assert_allclose(t_tx, j_tx, atol=1e-5, rtol=0)


def test_radio_null_device_matches_jax():
    t_out, t_err = _radio_run(t_radio, t_radio.RadioArgs(phy_srate_hz=2.0, dev_srate_hz=1.0),
                              device="cpu")
    j_out, j_err = _radio_run(j_radio, j_radio.RadioArgs(phy_srate_hz=2.0, dev_srate_hz=1.0))
    assert t_err == j_err == []
    for (a, ta), (b, tb) in zip(t_out, j_out):
        assert ta == tb and a.shape == b.shape and not a.any() and not b.any()


def _bridge_radios(R, **kw):
    """A TX radio and an RX radio joined by the IQ bridge (1:2 rates)."""
    port = free_base(0)
    tx = R.Radio(R.RadioArgs(device="bridge", tx_path=f"127.0.0.1:{port}",
                             phy_srate_hz=2.0, dev_srate_hz=1.0), **kw)
    t = threading.Thread(target=tx._tx_dev.accept)
    t.start()
    rx = R.Radio(R.RadioArgs(device="bridge", rx_path=f"127.0.0.1:{port}",
                             phy_srate_hz=2.0, dev_srate_hz=1.0), **kw)
    t.join(timeout=30)
    assert not t.is_alive()
    return tx, rx


def test_radio_bridge_device_matches_jax():
    x = _samples(2048, 5)
    got = []
    for R, kw, tensor in ((t_radio, {"device": "cpu"}, torch.from_numpy(x)), (j_radio, {}, x)):
        tx, rx = _bridge_radios(R, **kw)
        tx.tx(tensor)
        y, ts = rx.rx_now(2048)
        got.append((np.asarray(y), ts))
        tx.close()
        rx.close()
    (a, ta), (b, tb) = got
    assert ta == tb == 0.0 and a.shape == b.shape == (2048,)
    np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


# --- stack/gtpu ------------------------------------------------------------------


@pytest.mark.parametrize("teid,msg,seq,payload", [
    (0, 1, None, b""), (0x1234ABCD, 255, None, bytes(range(40))),
    (7, 255, 0xBEEF, b"ping0001"), (0xFFFFFFFF, 254, 0, b"\x00" * 1500)])
def test_gtpu_roundtrip_matches_jax(teid, msg, seq, payload):
    t_raw = t_gtpu.pack(t_gtpu.GtpuHeader(teid=teid, msg_type=msg, seq=seq), payload)
    assert t_raw == j_gtpu.pack(j_gtpu.GtpuHeader(teid=teid, msg_type=msg, seq=seq), payload)
    t_hdr, t_pl = t_gtpu.unpack(t_raw)
    j_hdr, j_pl = j_gtpu.unpack(t_raw)
    assert dataclasses.astuple(t_hdr) == dataclasses.astuple(j_hdr) == (teid, msg, seq)
    assert t_pl == j_pl == payload


# --- the apps --------------------------------------------------------------------


@pytest.mark.parametrize("app", ["srsenb", "srsue"])
@pytest.mark.parametrize("tm", [3, 4])
def test_tdd_with_spatial_multiplexing_is_a_usage_error(app, tm, capsys):
    main = importlib.import_module(f"srsran_4g_tpu_torch.apps.{app}").main
    with pytest.raises(SystemExit) as exc:
        main(["--tdd", "--tm", str(tm), "--device", "cpu"])
    assert exc.value.code == 2
    assert "--tdd supports --tm 1 only" in capsys.readouterr().err


def test_tm_and_cc_follow_the_config_file(tmp_path):
    from srsran_4g_tpu_torch.apps.srsenb import cell_mode

    conf = tmp_path / "enb.conf"
    conf.write_text((REPO / "srsran_4g_tpu_torch" / "apps" / "enb.conf.example").read_text()
                    .replace("nof_ports = 1", "nof_ports = 2").replace("tm = 1", "tm = 4")
                    + "\n[rat.eutra]\nnof_carriers = 2\n")
    cfg = t_config.load_config(str(conf))
    ap = argparse.ArgumentParser()
    flags = argparse.Namespace(tm=None, cc=None, tdd=False)
    assert cell_mode(ap, flags, cfg) == (4, 2, 2)
    assert cell_mode(ap, argparse.Namespace(tm=1, cc=1, tdd=False), cfg) == (1, 1, 1)
    assert cell_mode(ap, flags, t_config.load_config(None)) == (1, 1, 1)
    cfg.cell.nof_ports = 1  # tm = 4 on one port: the file disagrees with itself
    with pytest.raises(SystemExit):
        cell_mode(ap, flags, cfg)


@pytest.mark.parametrize("module,argv", [
    ("srsran_4g_tpu_torch.apps.srsenb", []), ("srsran_4g_tpu_torch.apps.srsue", []),
    ("srsran_4g_tpu_torch.tools.phy_e2e", ["ue"])])
def test_phy_apps_need_a_card_by_default(module, argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        importlib.import_module(module).main(argv)
    assert "CUDA is not available" in str(exc.value.code)
