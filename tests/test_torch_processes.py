"""The port's three-process deployment as OS processes, on the CPU.

- ``srsran_4g_tpu_torch.apps.{srsepc,srsenb,srsue}`` at the round-4 point of
  ``tests/test_three_process_e2e.py`` (6 PRB, 1 UE, 480 TTIs), wired by the
  IQ bridge, S1AP over TCP and GTP-U over UDP, held to every criterion of
  that test (``tools/three_process.criteria``).
- ``srsran_4g_tpu_torch.tools.phy_e2e`` at 6 PRB, as
  ``tests/test_e2e_bridge.py`` runs the repo's ``tools/phy_e2e.py``: every
  subframe's CRC passes and the payload matches.

Each child runs one torch thread (``OMP_NUM_THREADS=1``) on ``--device cpu``.
"""

import os
import subprocess
import sys
from pathlib import Path

from srsran_4g_tpu_torch.tools import three_process
from srsran_4g_tpu_torch.tools.three_process import free_base

REPO = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, OMP_NUM_THREADS="1")


def test_three_processes_attach_and_ping_on_cpu():
    run = three_process.run(three_process.Point(prb=6, ues=1, ttis=480), device="cpu",
                            env=ENV, timeout=600)
    checks = three_process.criteria(run)
    assert all(checks.values()), (checks, run.ue, run.enb, run.epc)
    assert run.attach_s[0] is not None and 0 < run.attach_s[0] < run.wall_s
    assert "turbo" not in run.enb and "turbo" not in run.ue[0]  # counts only on the card


def test_phy_e2e_loopback_on_cpu():
    port, n_sf = free_base(0), 6
    cmd = [sys.executable, "-m", "srsran_4g_tpu_torch.tools.phy_e2e", "--port", str(port),
           "--subframes", str(n_sf), "--prb", "6", "--device", "cpu"]
    enb = subprocess.Popen(cmd[:3] + ["enb"] + cmd[3:], cwd=REPO, env=ENV,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        ue = subprocess.run(cmd[:3] + ["ue"] + cmd[3:], cwd=REPO, env=ENV, capture_output=True,
                            text=True, timeout=300)
        enb_out, _ = enb.communicate(timeout=60)
        assert ue.returncode == 0, f"UE: {ue.stdout}\n{ue.stderr}\nENB: {enb_out}"
        assert f"{n_sf}/{n_sf} subframes CRC-OK" in ue.stdout
        assert "payload match=True" in ue.stdout
        assert enb.returncode == 0 and f"enb: streamed {n_sf} subframes" in enb_out
    finally:
        if enb.poll() is None:
            enb.kill()
        enb.wait(timeout=30)
