"""Typed configuration tree with INI-file/CLI overrides.

Counterpart of the reference's boost::program_options + libconfig++ config
system (srsue/ue.conf.example sections [rf] [rat.eutra] [pcap] [log] [usim]
[phy] ..., srsenb enb.conf + rr.conf parsers — SURVEY.md §5 "Config/flag
system").  Section and key names mirror the reference's so existing .conf
files translate directly.

Usage:
    cfg = load_config("ue.conf", overrides=["phy.nof_phy_threads=4"])
    cfg.rf.srate_hz, cfg.phy.snr_ema_coeff, ...
"""

from __future__ import annotations

import configparser
import dataclasses
from dataclasses import dataclass, field, fields
from typing import Any


@dataclass
class RfConfig:
    srate_hz: float = 11.52e6
    rx_gain: float = 40.0
    tx_gain: float = 70.0
    freq_offset: float = 0.0
    device_name: str = "file"  # file | zmq | null
    device_args: str = ""


@dataclass
class RatEutraConfig:
    dl_earfcn: int = 3350
    nof_carriers: int = 1


@dataclass
class PhyConfig:
    nof_phy_threads: int = 3  # kept for config parity; batching replaces it
    snr_ema_coeff: float = 0.1
    snr_estim_alg: str = "refs"
    pdsch_max_its: int = 4
    turbo_window: int = 128
    turbo_train: int = 32
    interpolate_subframe_enabled: bool = False
    cfo_is_doppler: bool = False
    force_ul_amplitude: float = 0.0


@dataclass
class CellConfigFile:
    nof_prb: int = 25
    cell_id: int = 1
    nof_ports: int = 1
    cfi: int = 1
    tm: int = 1  # transmission mode


@dataclass
class LogConfig:
    all_level: str = "warning"
    phy_level: str = "warning"
    filename: str = "/tmp/srsran_4g_tpu_torch.log"
    file_max_size: int = -1


@dataclass
class PcapConfig:
    enable: bool = False
    mac_filename: str = "/tmp/ue_mac.pcap"
    nas_filename: str = "/tmp/ue_nas.pcap"


@dataclass
class ChannelConfig:
    enable: bool = False
    awgn_enable: bool = False
    awgn_snr_db: float = 30.0
    fading_enable: bool = False
    fading_model: str = "epa5"  # profile + doppler, e.g. eva70
    delay_enable: bool = False
    delay_period_s: float = 3600.0
    delay_min_us: float = 10.0
    delay_max_us: float = 100.0
    rlf_enable: bool = False
    rlf_t_on_ms: float = 10000.0
    rlf_t_off_ms: float = 2000.0
    hst_enable: bool = False
    hst_fd_hz: float = 750.0


@dataclass
class ExpertConfig:
    batch_subframes: int = 32
    mesh_dp: int = 0  # 0 = auto
    mesh_sp: int = 1


@dataclass
class Config:
    rf: RfConfig = field(default_factory=RfConfig)
    rat_eutra: RatEutraConfig = field(default_factory=RatEutraConfig)
    phy: PhyConfig = field(default_factory=PhyConfig)
    cell: CellConfigFile = field(default_factory=CellConfigFile)
    log: LogConfig = field(default_factory=LogConfig)
    pcap: PcapConfig = field(default_factory=PcapConfig)
    channel: ChannelConfig = field(default_factory=ChannelConfig)
    expert: ExpertConfig = field(default_factory=ExpertConfig)


_SECTION_ALIASES = {
    "rat.eutra": "rat_eutra",
    "channel.dl": "channel",
    "channel.ul": "channel",
    "channel.dl.awgn": "channel",
    "channel.dl.fading": "channel",
    "channel.dl.delay": "channel",
    "channel.dl.rlf": "channel",
    "channel.dl.hst": "channel",
}

_KEY_PREFIX_BY_SECTION = {
    "channel.dl.awgn": "awgn_",
    "channel.dl.fading": "fading_",
    "channel.dl.delay": "delay_",
    "channel.dl.rlf": "rlf_",
    "channel.dl.hst": "hst_",
}


def _coerce(value: str, current: Any) -> Any:
    if isinstance(current, bool):
        return value.strip().lower() in ("1", "true", "yes", "on", "enable")
    if isinstance(current, int):
        return int(value, 0)
    if isinstance(current, float):
        return float(value)
    return value


def _set(cfg: Config, section: str, key: str, value: str) -> bool:
    sec_name = _SECTION_ALIASES.get(section, section)
    prefix = _KEY_PREFIX_BY_SECTION.get(section, "")
    if not hasattr(cfg, sec_name):
        return False
    sub = getattr(cfg, sec_name)
    attr = prefix + key
    if not hasattr(sub, attr):
        if hasattr(sub, key):
            attr = key
        else:
            return False
    setattr(sub, attr, _coerce(value, getattr(sub, attr)))
    return True


def load_config(
    path: str | None = None, overrides: list[str] | None = None
) -> Config:
    """Build a Config from an INI file plus 'section.key=value' overrides."""
    cfg = Config()
    unknown: list[str] = []
    if path:
        parser = configparser.ConfigParser(strict=False)
        parser.read(path)
        for section in parser.sections():
            for key, value in parser.items(section):
                if not _set(cfg, section, key, value):
                    unknown.append(f"{section}.{key}")
    for ov in overrides or []:
        dotted, _, value = ov.partition("=")
        section, _, key = dotted.rpartition(".")
        if not _set(cfg, section, key, value):
            unknown.append(dotted)
    if unknown:
        import warnings

        warnings.warn(f"unknown config keys ignored: {unknown}")
    return cfg


def to_dict(cfg: Config) -> dict:
    return dataclasses.asdict(cfg)


# --------------------------------------------------------------------------
# Structured eNB configs: rr.conf / sib.conf (libconfig++ subset)
# Counterpart of srsenb/src/parser.cc + enb_cfg_parser.cc.


@dataclass
class RrCellConfig:
    cell_id: int = 0x01
    pci: int = 1
    dl_earfcn: int = 3350
    tac: int = 0x0001
    root_seq_idx: int = 128
    scell_list: list = field(default_factory=list)


def _libconfig_parse(text: str):
    """Parse a libconfig-subset: groups {..}, lists (..), key = value;"""
    import re

    text = re.sub(r"//[^\n]*|#[^\n]*|/\*.*?\*/", "", text, flags=re.S)
    toks = re.findall(r"[{}()=;,]|\"[^\"]*\"|[^\s{}()=;,]+", text)
    pos = 0

    def parse_value():
        nonlocal pos
        t = toks[pos]
        if t == "{":
            pos += 1
            out = {}
            while toks[pos] != "}":
                key = toks[pos]
                assert toks[pos + 1] == "=", f"expected = after {key}"
                pos += 2
                out[key] = parse_value()
                while pos < len(toks) and toks[pos] in (";", ","):
                    pos += 1
            pos += 1
            return out
        if t == "(":
            pos += 1
            out = []
            while toks[pos] != ")":
                out.append(parse_value())
                while pos < len(toks) and toks[pos] == ",":
                    pos += 1
            pos += 1
            return out
        pos += 1
        if t.startswith('"'):
            return t.strip('"')
        try:
            return int(t, 0)
        except ValueError:
            try:
                return float(t)
            except ValueError:
                return t

    out = {}
    while pos < len(toks):
        key = toks[pos]
        assert toks[pos + 1] == "=", f"expected = after {key}"
        pos += 2
        out[key] = parse_value()
        while pos < len(toks) and toks[pos] in (";", ","):
            pos += 1
    return out


def load_rr_conf(path: str) -> list[RrCellConfig]:
    """Parse an rr.conf cell list (enb_cfg_parser.cc cell_list)."""
    with open(path) as f:
        tree = _libconfig_parse(f.read())
    cells = []
    for c in tree.get("cell_list", []):
        cell = RrCellConfig()
        for k, v in c.items():
            if hasattr(cell, k):
                setattr(cell, k, v)
        cells.append(cell)
    return cells
