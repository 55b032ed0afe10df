"""Radio layer: device abstraction + rate conversion.

Counterpart of the reference's `lib/src/radio/radio.cc` (carrier/port→
device-channel mapping, FFT resampling between PHY rate and device rate,
timestamp bookkeeping) over the `rf_dev_t` plugin vtable
(lib/src/phy/rf/rf_dev.h) with its {zmq, file, null, ...} device table.

Devices here: "null" (zeros), "file" (record/replay, filesource-compatible)
and "bridge" (the native TCP IQ bridge — the ZMQ-virtual-radio equivalent
that lets a UE process and an eNB process run against each other with no
hardware, sample-count as the clock).

Port counterpart of ``srsran_4g_tpu/runtime/radio.py``: the devices read and
write numpy samples on the host, and the radio hands the PHY torch tensors on
its own device (default CUDA; there is no CPU fallback: ``device="cpu"`` asks
for the CPU), so the rate conversion (``ops/resampling.resample_fft``) runs
there: one host-to-device copy a read, one device-to-host copy a write.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from math import gcd
from typing import Callable, Optional

import numpy as np
import torch

from srsran_4g_tpu_torch import resolve_device
from srsran_4g_tpu_torch.ops.resampling import resample_fft
from srsran_4g_tpu_torch.utils.io import FileSink, FileSource


class RadioError(enum.Enum):
    """RF device error kinds (rf.h:63-73 srsran_rf_error_t)."""

    LATE = "late"
    UNDERFLOW = "underflow"
    OVERFLOW = "overflow"
    RX = "rx"


@dataclass
class RadioArgs:
    device: str = "null"  # null | file | bridge
    rx_path: str = ""  # file path or host:port
    tx_path: str = ""
    phy_srate_hz: float = 11.52e6
    dev_srate_hz: float = 11.52e6


class Radio:
    """rx_now/tx with PHY↔device rate conversion (radio.cc:290,420).

    `error_handler` is the RF error callback of the reference's plugin
    contract (rf.h:194 srsran_rf_register_error_handler): the PHY sync
    layer registers it and reacts to OVERFLOW/UNDERFLOW/LATE by forcing
    a resync (srsue/src/phy/sync.cc radio_error).

    `device`: the torch device of the samples ``rx_now`` returns and the
    rate conversion runs on."""

    def __init__(self, args: RadioArgs, device: torch.device | str | None = None):
        self.args = args
        self.device = resolve_device(device)
        self._rx_count = 0
        self._rx_dev = None
        self._tx_dev = None
        self.error_handler: Optional[Callable[[RadioError], None]] = None
        self.error_counts: dict[RadioError, int] = {e: 0 for e in RadioError}
        self._pending_drop = 0
        if args.device == "file":
            if args.rx_path:
                self._rx_dev = FileSource(args.rx_path)
            if args.tx_path:
                self._tx_dev = FileSink(args.tx_path)
        elif args.device == "bridge":
            from srsran_4g_tpu_torch.runtime.native import IqBridgeRx, IqBridgeTx

            if args.tx_path:
                port = int(args.tx_path.rsplit(":", 1)[1])
                self._tx_dev = IqBridgeTx(port)
            if args.rx_path:
                host, port = args.rx_path.rsplit(":", 1)
                self._rx_dev = IqBridgeRx(host, int(port))
        elif args.device != "null":
            raise ValueError(f"unknown radio device {args.device}")

    @property
    def _ratio(self) -> tuple[int, int]:
        up = int(self.args.phy_srate_hz)
        down = int(self.args.dev_srate_hz)
        g = gcd(up, down)
        return up // g, down // g

    def _fire(self, err: RadioError) -> None:
        self.error_counts[err] += 1
        if self.error_handler is not None:
            self.error_handler(err)

    def inject_drop(self, nof_dev_samples: int) -> None:
        """Fault injection: the device drops samples before the next read
        (an RX-ring overflow — the 'O' the reference prints)."""
        self._pending_drop += nof_dev_samples

    def rx_now(self, nof_samples_phy: int) -> tuple[torch.Tensor, float]:
        """Receive exactly nof_samples at the PHY rate; returns (complex64
        samples on the radio's device, timestamp in seconds of the first
        sample)."""
        up, down = self._ratio
        n_dev = nof_samples_phy * down // up
        ts = self._rx_count / self.args.phy_srate_hz
        if self._rx_dev is None:
            dev = np.zeros(n_dev, np.complex64)
        else:
            if self._pending_drop > 0 and hasattr(self._rx_dev, "read"):
                # stream discontinuity: consume-and-discard, then report
                self._rx_dev.read(self._pending_drop)
                self._pending_drop = 0
                self._fire(RadioError.OVERFLOW)
            dev = self._rx_dev.read(n_dev)
            short = getattr(self._rx_dev, "last_read_short", 0)
            if short > 0:
                # device could not deliver a full buffer (stalled stream)
                self._fire(RadioError.UNDERFLOW)
        self._rx_count += nof_samples_phy
        x = torch.from_numpy(dev).to(self.device)
        if up == down:
            return x, ts
        return resample_fft(x, up, down), ts

    def tx(self, samples_phy: torch.Tensor) -> None:
        """Send samples at the PHY rate (a complex tensor on any device)."""
        up, down = self._ratio
        x = torch.as_tensor(samples_phy).to(torch.complex64)
        if up != down:
            x = resample_fft(x, down, up)
        dev = x.cpu().numpy()
        if self._tx_dev is not None:
            if hasattr(self._tx_dev, "send"):
                self._tx_dev.send(dev)
            else:
                self._tx_dev.write(dev)

    def close(self) -> None:
        for d in (self._rx_dev, self._tx_dev):
            if d is not None and hasattr(d, "close"):
                d.close()
