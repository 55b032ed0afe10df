"""The port imports with JAX blocked and never imports the JAX package."""

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
            "models.prach", "models.srs")

_CHECK = """
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import srsran_4g_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("srsran_4g_tpu", "jaxlib"))
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
