"""The three-process LTE deployment: the port's ``srsepc``, ``srsenb`` and one
``srsue`` a UE as OS processes, wired by the native TCP IQ bridge (UE i on
ports dl+2i and ul+2i; the eNB broadcasts DL and sums the UL streams), S1AP
over TCP and GTP-U over UDP.

The counterpart of the reference's ``test/run_lte.sh:82-160`` (three
processes over ZMQ RF) and of the launcher in the repo's
``tests/test_three_process_e2e.py``, whose pass criteria ``criteria`` holds
a run to: every UE attaches and camps, exactly one PRACH a UE, no PDSCH or
PUSCH KO, no DL or UL ping lost, every CQI after the first at 13 or more; TM4
sends and decodes rank 2 across the process boundary; 2-CC CA drains part of
a DL burst on the SCell.  Each child's output lines are stamped with the host
clock as they arrive, so a run also reads when the bridges came up, when each
UE attached and when the last RESULT line came.

    python -m srsran_4g_tpu_torch.tools.three_process --prb 100 --ues 2 --ttis 600

The apps run on ``--device`` (default CUDA; there is no CPU fallback:
``--device cpu`` asks for the CPU).  Ports are picked free from the OS.
"""

from __future__ import annotations

import argparse
import json
import socket
import subprocess
import sys
import threading
import time
from dataclasses import asdict, dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PINGS = 2
BURST_BYTES = 4000  # 2-CC CA: one DL burst above a 6 PRB PCell's per-TTI capacity
PORT_SPAN = 60      # ports a deployment uses above its base (SCells at dl+50+2i)
# the fixed ports of the repo's JAX-side bridge and three-process tests
# (tests/test_runtime_native.py, test_e2e_bridge.py,
# test_three_process_e2e.py), kept clear so that both can run side by side
FIXED_PORTS = range(44000, 47000)


@dataclass(frozen=True)
class Point:
    """One deployment: cell width, UEs, TTIs, transmission mode, frame
    structure and component carriers (the matrix of
    ``tests/test_three_process_e2e.py``)."""

    prb: int = 6
    ues: int = 1
    ttis: int = 480
    tm: int = 1
    tdd: bool = False
    cc: int = 1
    pings: int = PINGS


def _free(port: int) -> bool:
    for kind in (socket.SOCK_STREAM, socket.SOCK_DGRAM):
        with socket.socket(socket.AF_INET, kind) as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                return False
    return True


def free_base(span: int = PORT_SPAN) -> int:
    """A port p such that p..p+span are free for TCP and UDP now and clear
    of FIXED_PORTS; p is one the OS hands out for port 0."""
    for _ in range(100):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            base = s.getsockname()[1]
        ports = range(base, base + span + 1)
        if (ports[-1] < 65536 and not set(ports) & set(FIXED_PORTS)
                and all(_free(p) for p in ports)):
            return base
    raise OSError(f"no {span + 1} free ports in a row")


class Child:
    """One process of the deployment; a thread stamps its output lines
    (stdout and stderr, merged) with the host clock as they arrive."""

    def __init__(self, name: str, module: str, args: list[str], env: dict | None) -> None:
        self.name = name
        self.proc = subprocess.Popen(
            [sys.executable, "-m", module, *args], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, bufsize=1)
        self.lines: list[tuple[float, str]] = []
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            self.lines.append((time.perf_counter(), line.rstrip("\n")))

    def stamp(self, prefix: str) -> float | None:
        """When the first line starting with ``prefix`` arrived."""
        return next((t for t, line in list(self.lines) if line.startswith(prefix)), None)

    def wait_line(self, prefix: str, timeout: float) -> float:
        end = time.perf_counter() + timeout
        while (t := self.stamp(prefix)) is None:
            if self.proc.poll() is not None or time.perf_counter() > end:
                raise AssertionError(f"{self.name}: no {prefix!r} line "
                                     f"(rc={self.proc.poll()}):\n{self.output()}")
            time.sleep(0.02)
        return t

    def output(self) -> str:
        return "\n".join(line for _, line in self.lines)

    def result(self, timeout: float) -> dict:
        """The child's RESULT line, once it has exited 0 (else raises)."""
        rc = self.proc.wait(timeout=timeout)
        self._reader.join(timeout=10)
        if rc != 0:
            raise AssertionError(f"{self.name} exited {rc}:\n{self.output()}")
        for _, line in self.lines:
            if line.startswith("RESULT "):
                return json.loads(line[len("RESULT "):])
        raise AssertionError(f"{self.name}: no RESULT line:\n{self.output()}")

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=30)
        self._reader.join(timeout=10)
        self.proc.stdout.close()


@dataclass
class Run:
    """A deployment's results: each child's RESULT; host-clock seconds from
    the eNB's start to its "IQ bridges up" line, and from that line to each
    UE's ATTACHED line and to the last RESULT line."""

    point: Point
    ue: list[dict]
    enb: dict
    epc: dict
    setup_s: float
    attach_s: list[float | None]
    wall_s: float
    outputs: dict[str, str] = field(repr=False)

    @property
    def ttis_per_s(self) -> float:
        return self.point.ttis / self.wall_s


def run(point: Point, device: str = "cuda", env: dict | None = None,
        timeout: float = 1500.0) -> Run:
    """Start the EPC, then the eNB and the UEs, and collect every RESULT;
    every child is killed on the way out, whatever happened."""
    base = free_base()
    s1ap_port, gtpu_port, dl_port, ul_port = base + 12, base + 52, base + 1, base + 2
    phy = ["--prb", str(point.prb), "--ttis", str(point.ttis), "--tm", str(point.tm),
           "--cc", str(point.cc), "--device", device] + (["--tdd"] if point.tdd else [])
    children: list[Child] = []
    try:
        epc = Child("srsepc", "srsran_4g_tpu_torch.apps.srsepc",
                    ["--s1ap-port", str(s1ap_port), "--gtpu-port", str(gtpu_port),
                     "--ues", str(point.ues), "--pings", str(point.pings),
                     "--timeout", str(timeout)]
                    + (["--burst-bytes", str(BURST_BYTES)] if point.cc == 2 else []), env)
        children.append(epc)
        epc.wait_line("srsepc: S1AP on", timeout=120)
        start = time.perf_counter()
        enb = Child("srsenb", "srsran_4g_tpu_torch.apps.srsenb",
                    ["--dl-port", str(dl_port), "--ul-port", str(ul_port),
                     "--s1ap-port", str(s1ap_port), "--gtpu-port", str(gtpu_port),
                     "--ues", str(point.ues), *phy], env)
        children.append(enb)
        ues = []
        for i in range(point.ues):
            ues.append(Child(f"srsue{i}", "srsran_4g_tpu_torch.apps.srsue",
                             ["--dl-port", str(dl_port + 2 * i), "--ul-port", str(ul_port + 2 * i),
                              "--ue-idx", str(i), *phy], env))
            children.append(ues[-1])
        ue_stats = [u.result(timeout) for u in ues]
        enb_stats = enb.result(timeout=300)
        epc_stats = epc.result(timeout=120)
        up = enb.stamp("srsenb: IQ bridges up")
        last = max(c.stamp("RESULT ") for c in children)
        attach = [None if (t := u.stamp("srsue: ATTACHED")) is None else t - up for u in ues]
        return Run(point, ue_stats, enb_stats, epc_stats, up - start, attach, last - up,
                   {c.name: c.output() for c in children})
    finally:
        for c in children:
            c.kill()


def criteria(r: Run) -> dict[str, bool]:
    """``tests/test_three_process_e2e.py``'s pass criteria on a run."""
    p = r.point
    n_extra = 1 if p.cc == 2 else 0  # the burst is one more DL packet
    checks = {
        "every UE registered": all(st["registered"] for st in r.ue),
        "every UE camped": all(st["sync_state"] == "camped" for st in r.ue),
        "0 PDSCH KO": all(st["pdsch_ko"] == 0 for st in r.ue),
        "0% DL ping loss": all(st["dl_ping_rx"] == p.pings + n_extra for st in r.ue),
        "CQI >= 13 after the first report": all(c >= 13 for st in r.ue for c in st["cqi"][1:]),
        "one PRACH a UE": r.enb["prach"] == p.ues,
        "0 PUSCH KO": r.enb["pusch_ko"] == 0,
        "0% UL ping loss": r.epc["ul_ping_rx"] >= p.pings * p.ues + n_extra,
        "every UE attached at the EPC": r.epc["attach"] == p.ues,
    }
    if p.tm == 4:
        checks["rank 2 sent"] = r.enb.get("pdsch_tx_rank2", 0) > 0
        checks["rank 2 decoded"] = any(st.get("pdsch_rank2", 0) > 0 for st in r.ue)
    if p.cc == 2:
        checks["SCell carried data"] = r.enb.get("scell_tx", 0) > 0
    return checks


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    for name, default in asdict(Point()).items():
        if isinstance(default, bool):
            ap.add_argument(f"--{name}", action="store_true")
        else:
            ap.add_argument(f"--{name}", type=int, default=default)
    ap.add_argument("--device", default="cuda", help="torch device of the PHYs (default cuda)")
    args = vars(ap.parse_args(argv))
    device = args.pop("device")
    r = run(Point(**args), device=device)
    checks = criteria(r)
    print(f"{r.point}: bridges up {r.setup_s:.2f} s after the eNB started; {r.point.ttis} TTIs "
          f"in {r.wall_s:.2f} s from there ({r.ttis_per_s:.2f} TTIs/s); attached at "
          f"{r.attach_s} s")
    for name, st in (*((f"srsue{i}", st) for i, st in enumerate(r.ue)),
                     ("srsenb", r.enb), ("srsepc", r.epc)):
        print(f"{name}: {json.dumps(st)}")
    print(json.dumps(checks))
    return 0 if all(checks.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
