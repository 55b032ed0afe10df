"""UE NAS (EMM) state machine — TS 24.301 attach/detach/auth.

Counterpart of `srsue/src/stack/upper/nas.cc` (2.1 k LoC: EMM FSM with
attach, AKA authentication, security mode, ESM default bearer, detach;
timers T3402/3410/3411/3421 per `srsue/hdr/stack/upper/nas.h:137-148`).

The entity is transport-agnostic: `start_attach()` returns the initial
NAS PDU and `rx(pdu)` returns response PDUs; the RRC layer carries them
(rrc_ue.py) exactly as the reference's rrc<->nas interface does.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from . import nas_msgs as M
from . import security
from . import tft
from .usim import Usim, UsimConfig

EMM_DEREGISTERED = "DEREGISTERED"
EMM_REGISTERED_INITIATED = "REGISTERED_INITIATED"
EMM_REGISTERED = "REGISTERED"
EMM_DEREGISTERED_INITIATED = "DEREGISTERED_INITIATED"


@dataclass
class NasTimers:
    """EMM timers (nas.h:137-148), tick()-driven in ms."""
    t3410_ms: int = 15000  # attach guard
    t3411_ms: int = 10000  # attach retry
    t3421_ms: int = 15000  # detach guard


class NasUe:
    def __init__(self, usim: Usim | None = None, apn: str = "srsapn") -> None:
        self.usim = usim or Usim()
        self.apn = apn
        self.state = EMM_DEREGISTERED
        self.timers = NasTimers()
        self.t3410 = 0
        self.attach_attempts = 0
        # security context
        self.k_nas_int: Optional[bytes] = None
        self.k_nas_enc: Optional[bytes] = None
        self.ul_count = 0
        self.dl_count = 0
        self.eia = 0
        self.eea = 0
        self.ciphered = False
        self.k_enb: Optional[bytes] = None
        # session results
        self.ip_addr: Optional[bytes] = None
        self.guti_mtmsi = 0
        self.eps_bearer_id = 0
        # dedicated bearers: ebi -> linked (default) ebi; UL packets are
        # steered by the TFT matcher (gw.cc/tft_packet_filter.cc role)
        self.dedicated_bearers: dict[int, int] = {}
        self.tft_matcher = tft.TftMatcher()
        self.tau_pending = False
        self.events: list[str] = []

    # -- outbound helpers --------------------------------------------------

    def _protect(self, plain: bytes, new_ctx: bool = False) -> bytes:
        if self.k_nas_int is None:
            return plain
        if self.ciphered:
            hdr = (M.SEC_INTEGRITY_CIPHERED_NEW_CTX if new_ctx
                   else M.SEC_INTEGRITY_CIPHERED)
            enc = self.k_nas_enc
        else:
            hdr = M.SEC_INTEGRITY_NEW_CTX if new_ctx else M.SEC_INTEGRITY
            enc = None
        out = M.pack_protected(plain, self.k_nas_int, enc, self.ul_count,
                               M.NAS_DIR_UL, hdr)
        self.ul_count += 1
        return out

    # -- procedures --------------------------------------------------------

    def start_attach(self) -> bytes:
        """Returns the initial AttachRequest (with piggybacked PDN
        connectivity) to send in RRCConnectionSetupComplete."""
        self.state = EMM_REGISTERED_INITIATED
        self.attach_attempts += 1
        self.t3410 = 0
        esm = bytes([M.PD_ESM, 1, M.MSG_PDN_CONNECTIVITY_REQUEST, 0x01])
        req = M.AttachRequest(imsi=self.usim.imsi, esm_msg=esm)
        self.events.append("attach_request")
        return req.pack()

    def rx(self, pdu: bytes) -> list[bytes]:
        """Process a DL NAS PDU; returns UL NAS PDUs to send."""
        sec_hdr = pdu[0] >> 4
        if sec_hdr != M.SEC_NONE and self.k_nas_int is None:
            # Security Mode Command arrives integrity-protected before the
            # UE has a NAS context (24.301 4.4.5): parse the inner message,
            # derive keys from the indicated algorithms, then verify MAC.
            inner = pdu[6:]
            try:
                msg = M.parse(inner)
            except (ValueError, AssertionError, IndexError):
                self.events.append("malformed")
                return []
            if isinstance(msg, M.SecurityModeCommand):
                k_asme = self.usim.get_k_asme()
                k_int = security.k_nas(k_asme, msg.eia, integrity=True)
                _, ok, count = M.unpack_protected(
                    pdu, k_int, None, self.dl_count, M.NAS_DIR_DL)
                if not ok:
                    self.events.append("smc_integrity_failure")
                    return []
                self.dl_count = count + 1
                return self._dispatch(msg)
            self.events.append("protected_before_ctx")
            return []
        if sec_hdr != M.SEC_NONE:
            plain, ok, count = M.unpack_protected(
                pdu, self.k_nas_int, self.k_nas_enc if self.ciphered else None,
                self.dl_count, M.NAS_DIR_DL)
            if not ok:
                self.events.append("integrity_failure")
                return []
            self.dl_count = count + 1
        else:
            plain = pdu
        try:
            msg = M.parse(plain)
        except (ValueError, AssertionError, IndexError):
            self.events.append("malformed")
            return []
        return self._dispatch(msg)

    def _dispatch(self, msg) -> list[bytes]:
        if isinstance(msg, M.AuthenticationRequest):
            status, res = self.usim.generate_authentication_response(
                msg.rand, msg.autn)
            if status == "ok":
                self.events.append("auth_ok")
                return [M.AuthenticationResponse(res=res).pack()]
            self.events.append(f"auth_{status}")
            cause = 20 if status == "mac_failure" else 21
            return [M.AuthenticationFailure(cause=cause, auts=res).pack()]

        if isinstance(msg, M.SecurityModeCommand):
            k_asme = self.usim.get_k_asme()
            self.eia, self.eea = msg.eia, msg.eea
            self.k_nas_int = security.k_nas(k_asme, self.eia, integrity=True)
            self.k_nas_enc = security.k_nas(k_asme, self.eea, integrity=False)
            self.ul_count = 0  # new security context resets the UL count
            out = M.SecurityModeComplete(imeisv=self.usim.cfg.imei).pack()
            protected = self._protect(out, new_ctx=True)
            self.ciphered = self.eea != 0
            # snapshot K_eNB at the UL NAS COUNT the MME will see when it
            # runs InitialContextSetup (the count after SecurityModeComplete)
            self.k_enb = security.k_enb(k_asme, self.ul_count)
            self.events.append("smc_done")
            return [protected]

        if isinstance(msg, M.AttachAccept):
            self.guti_mtmsi = msg.guti_mtmsi
            uls = []
            if msg.esm_msg:
                esm = M.parse(msg.esm_msg)
                if isinstance(esm, M.ActivateDefaultEpsBearerRequest):
                    self.ip_addr = esm.ip_addr
                    self.eps_bearer_id = esm.eps_bearer_id
                    self.tft_matcher.default_bearer_id = esm.eps_bearer_id
                    accept = M.ActivateDefaultEpsBearerAccept(
                        eps_bearer_id=esm.eps_bearer_id, pti=esm.pti).pack()
                    comp = M.AttachComplete(esm_msg=accept).pack()
                    uls.append(self._protect(comp))
            self.state = EMM_REGISTERED
            self.events.append("attach_complete")
            return uls

        if isinstance(msg, M.ActivateDedicatedEpsBearerRequest):
            filters = tft.parse_tft(msg.tft, msg.eps_bearer_id) \
                if msg.tft else []
            self.tft_matcher.apply_tft(msg.eps_bearer_id, filters)
            self.dedicated_bearers[msg.eps_bearer_id] = msg.linked_ebi
            self.events.append(f"dedicated_bearer:{msg.eps_bearer_id}")
            return [self._protect(M.ActivateDedicatedEpsBearerAccept(
                eps_bearer_id=msg.eps_bearer_id, pti=msg.pti).pack())]

        if isinstance(msg, M.DetachRequest):
            self.state = EMM_DEREGISTERED
            self.events.append("detached")
            return []

        if isinstance(msg, M.TrackingAreaUpdateAccept):
            if msg.guti_mtmsi:
                self.guti_mtmsi = msg.guti_mtmsi
            self.tau_pending = False
            self.events.append("tau_accept")
            return [self._protect(M.TrackingAreaUpdateComplete().pack())]

        if isinstance(msg, M.ServiceReject):
            # cause 9/10: identity not derivable → re-attach (24.301 5.6.1.5)
            self.state = EMM_DEREGISTERED
            self.events.append(f"service_reject:{msg.cause}")
            return []

        self.events.append(f"unhandled:{type(msg).__name__}")
        return []

    def start_service_request(self) -> bytes:
        """ECM-IDLE → CONNECTED: the 4-byte short service request
        (nas.cc gen_service_request), sent as the RRC establishment's
        dedicated NAS info."""
        assert self.state == EMM_REGISTERED and self.k_nas_int
        pdu = M.pack_service_request(self.k_nas_int, self.ul_count)
        self.ul_count += 1
        self.events.append("service_request")
        return pdu

    def start_tau(self, update_type: int = 0) -> bytes:
        """Tracking area update request (nas.cc send_tracking_area_update
        _request), integrity-protected with the current context."""
        assert self.state == EMM_REGISTERED and self.k_nas_int
        req = M.TrackingAreaUpdateRequest(
            update_type=update_type, guti_mtmsi=self.guti_mtmsi)
        self.tau_pending = True
        self.events.append("tau_request")
        return self._protect(req.pack())

    def start_detach(self) -> bytes:
        self.state = EMM_DEREGISTERED_INITIATED
        return self._protect(M.DetachRequest(switch_off=True).pack())

    def tick(self, ms: int = 1) -> Optional[bytes]:
        """T3410 attach-guard expiry -> retry attach."""
        if self.state == EMM_REGISTERED_INITIATED:
            self.t3410 += ms
            if self.t3410 > self.timers.t3410_ms:
                self.events.append("t3410_expiry")
                return self.start_attach()
        return None

    def is_registered(self) -> bool:
        return self.state == EMM_REGISTERED

    def get_k_enb(self) -> bytes:
        """K_eNB snapshot taken at SMC completion (33.401 A.3); mirrors
        the MME's derivation at InitialContextSetup time."""
        assert self.k_enb is not None, "security mode not yet run"
        return self.k_enb
