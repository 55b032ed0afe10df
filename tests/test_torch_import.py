"""The port imports with JAX and ``cryptography`` blocked and never imports
the JAX package."""

import pkgutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
# modules each slice added, which the walk below must find and import
EXPECTED = ("ops.cuda.turbo_map", "models.pdsch", "models.pdsch_mimo", "ops.ofdm",
            "ops.zadoff_chu", "models.sync", "models.pcfich", "models.enb_dl", "models.ue_dl",
            "ops.cuda.probes", "tools.turbo_probe2", "tools.turbo_probe3", "tools.turbo_probe6",
            "tools.turbo_probe7", "utils.bits", "ops.convcode", "models.regs", "models.phich",
            "models.pbch", "models.pdcch", "models.dci", "models.ra", "tools.fused16_split",
            "tools.windowed_split", "tools.fused_split", "ops.resampling", "ops.agc", "ops.cfr",
            "ops.block_code", "models.tdd", "models.ue_sync", "models.meas", "models.pmch",
            "models.refsignal_ul", "models.cqi", "models.uci", "models.pusch", "models.pucch",
            "models.prach", "models.srs", "channel.fading", "channel.impairments",
            "runtime.lte_air", "apps.nodes", "tools.run_lte",
            "config", "runtime.tasks", "runtime.native", "runtime.radio", "apps.srsepc",
            "apps.srsenb", "apps.srsue", "tools.phy_e2e", "tools.three_process",
            "ops.ldpc", "ops.polar", "ops.polar_3gpp", "models.grid_nr", "models.sch_nr",
            "models.dci_nr", "models.ra_nr", "models.harq_ack_nr", "models.pdsch_nr",
            "models.ssb", "models.ue_sync_nr", "models.pdcch_nr", "models.pucch_nr",
            "models.pusch_nr", "tools.run_nr", "models.ra_sl", "models.sidelink",
            "models.sl_rx", "models.nbiot", "models.nbiot_data", "models.csi_nr",
            "models.coreset0", "parallel.mesh", "parallel.dist", "parallel.stream",
            "parallel.pipeline", "tools.multichip", "tools.ber_sweep", "tools.bler_sweep",
            *(f"utils.{m}" for m in ("io", "log", "metrics", "sys_metrics", "checkpoint",
                                     "crash_handler")),
            *(f"stack.{m}" for m in (
                "security", "snow3g_zuc", "asn1", "aper", "rrc_uper", "rrc_msgs", "s1ap_per",
                "s1ap_ies", "s1ap_msgs", "nas_msgs", "tft", "usim", "pdcp", "pdcp_nr", "rlc_um",
                "rlc_am", "mac_pdu", "sched", "enb_mac", "ue_mac", "nas_ue", "rrc_idle",
                "rrc_meas", "rrc_ue", "rrc_enb", "epc", "gtpu", "gtpc", "mbms_gw", "x2", "e2",
                "e2ap_per", "nas_eps_codec", "mac_pdu_nr", "rlc_nr", "nas_5gs_codec", "nas_5g",
                "ngap", "rrc_nr_uper", "rrc_nr", "sched_nr", "ue_mac_nr", "rrc_nbiot")))

_CHECK = """
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.modules["cryptography"] = None  # the port's AES is its own
import srsran_4g_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("srsran_4g_tpu", "jaxlib", "cryptography")
             and sys.modules[m] is not None)
print(len(names), bad)
"""


def test_port_imports_without_jax():
    res = subprocess.run([sys.executable, "-c", _CHECK], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    n_modules, bad = res.stdout.split(maxsplit=1)
    walked = {m.name for m in pkgutil.walk_packages(
        [str(REPO / "srsran_4g_tpu_torch")], "srsran_4g_tpu_torch.")}
    assert int(n_modules) == len(walked) >= 20
    assert {"srsran_4g_tpu_torch." + m for m in EXPECTED} <= walked
    assert bad.strip() == "[]"
