"""Spot reporting: console table + PSKreporter IPFIX/UDP uplink.

Console format matches the reference's printSpots
(/root/reference/rtlsdr_ft8d.c:643-663). The PSKreporter uplink uses the
native C++ frame builder (native/ipfix.cc — wire format from c:365-590)
with a pure-Python fallback; like the reference's shipped state, reporting
is OFF unless explicitly enabled (the reference hard-disables it at c:366).
"""

import ctypes
import random
import socket
import struct
import time

APP_VERSION = "jax-ft8d-0.1"
PSK_HOST = "report.pskreporter.info"
PSK_PORT = 4739

RX_DESCRIPTOR = bytes([
    0x00, 0x03, 0x00, 0x24, 0x99, 0x92, 0x00, 0x03, 0x00, 0x00,
    0x80, 0x02, 0xFF, 0xFF, 0x00, 0x00, 0x76, 0x8F,
    0x80, 0x04, 0xFF, 0xFF, 0x00, 0x00, 0x76, 0x8F,
    0x80, 0x08, 0xFF, 0xFF, 0x00, 0x00, 0x76, 0x8F,
    0x00, 0x00])

TX_DESCRIPTOR = bytes([
    0x00, 0x02, 0x00, 0x3C, 0x99, 0x93, 0x00, 0x07,
    0x80, 0x01, 0xFF, 0xFF, 0x00, 0x00, 0x76, 0x8F,
    0x80, 0x05, 0x00, 0x04, 0x00, 0x00, 0x76, 0x8F,
    0x80, 0x06, 0x00, 0x01, 0x00, 0x00, 0x76, 0x8F,
    0x80, 0x0A, 0xFF, 0xFF, 0x00, 0x00, 0x76, 0x8F,
    0x80, 0x03, 0xFF, 0xFF, 0x00, 0x00, 0x76, 0x8F,
    0x80, 0x0B, 0x00, 0x01, 0x00, 0x00, 0x76, 0x8F,
    0x00, 0x96, 0x00, 0x04])


def print_spots(decodes, when, dial_freq_hz=0, out=None):
    """Reference console format (c:643-663), extended with the full text."""
    import sys
    out = out or sys.stdout
    stamp = f"{when.year:04d}-{when.month:02d}-{when.day:02d} " \
            f"{when.hour:02d}:{when.minute:02d}z"
    if not decodes:
        print(f"No spot {stamp}", file=out)
        return
    print("  Score    SNR     Freq    DT       Call    Loc  Message",
          file=out)
    for d in decodes:
        print(f"     {d.score:2d} {d.snr_db:+5.1f} {int(d.freq_hz) + dial_freq_hz:8d} "
              f"{d.time_sec:+5.2f} {d.call:>10s} {d.loc:>6s}  {d.text}",
              file=out)


def _varstr(s: str) -> bytes:
    b = s.encode()[:255]
    return bytes([len(b)]) + b


def build_ipfix_frame_py(rx_call, rx_loc, spots, epoch, sequence,
                         session_id):
    """Pure-Python mirror of native ipfix_build_frame.

    spots: iterable of (call, locator, freq_hz, snr_db, epoch).
    """
    rx_info = bytearray(b"\x99\x92\x00\x00")
    rx_info += _varstr(rx_call) + _varstr(rx_loc) + _varstr(APP_VERSION)
    while len(rx_info) % 4:
        rx_info += b"\x00"
    struct.pack_into(">H", rx_info, 2, len(rx_info))

    tx_info = bytearray(b"\x99\x93\x00\x00")
    for call, loc, freq, snr, ep in spots:
        if len(tx_info) > 1200:     # reference per-frame budget (c:497)
            break
        tx_info += _varstr(call)
        tx_info += struct.pack(">I", int(freq) & 0xFFFFFFFF)
        tx_info += struct.pack(">b", max(-128, min(127, int(snr))))
        tx_info += _varstr("FT8")
        tx_info += _varstr(loc)
        tx_info += b"\x01"
        tx_info += struct.pack(">I", int(ep))
    while len(tx_info) % 4:
        tx_info += b"\x00"
    struct.pack_into(">H", tx_info, 2, len(tx_info))

    total = 16 + len(RX_DESCRIPTOR) + len(TX_DESCRIPTOR) + len(rx_info) \
        + len(tx_info)
    header = struct.pack(">HHIII", 0x000A, total, int(epoch), sequence,
                         session_id & 0xFFFFFFFF)
    return header + RX_DESCRIPTOR + TX_DESCRIPTOR + bytes(rx_info) \
        + bytes(tx_info)


class PskReporter:
    """Stateful uplink: sequence numbers, session id, UDP send."""

    def __init__(self, rx_call: str, rx_loc: str, enabled: bool = False,
                 host: str = PSK_HOST, port: int = PSK_PORT):
        self.rx_call = rx_call
        self.rx_loc = rx_loc
        self.enabled = enabled
        self.host = host
        self.port = port
        self.sequence = 1
        self.session_id = random.getrandbits(32)
        self._native = None
        try:
            from .. import native
            self._native = native.load(build_if_missing=False)
        except Exception:
            pass

    def build_frame(self, spots, epoch=None):
        epoch = int(epoch if epoch is not None else time.time())
        if self._native is not None:
            from ..native import Ft8Spot
            arr = (Ft8Spot * max(1, len(spots)))()
            for i, (call, loc, freq, snr, ep) in enumerate(spots):
                arr[i].call = call.encode()[:15]
                arr[i].locator = loc.encode()[:7]
                arr[i].freq_hz = int(freq) & 0xFFFFFFFF
                arr[i].snr_db = max(-128, min(127, int(snr)))
                arr[i].epoch = int(ep)
            buf = (ctypes.c_uint8 * 2048)()
            n = self._native.ipfix_build_frame(
                buf, 2048, self.rx_call.encode(), self.rx_loc.encode(),
                APP_VERSION.encode(), arr, len(spots), epoch,
                self.sequence, self.session_id)
            if n > 0:
                return bytes(buf[:n])
        return build_ipfix_frame_py(self.rx_call, self.rx_loc, spots,
                                    epoch, self.sequence, self.session_id)

    def report(self, decodes, dial_freq_hz, epoch=None):
        """Send CQ spots (like the reference, c:1510) for one window."""
        if not self.enabled or not decodes:
            return None
        epoch = int(epoch if epoch is not None else time.time())
        spots = [(d.call, d.loc, int(d.freq_hz) + dial_freq_hz,
                  int(d.snr_db), epoch)
                 for d in decodes if d.is_cq and d.call]
        if not spots:
            return None
        frame = self.build_frame(spots, epoch)
        self.sequence += 1
        try:
            with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
                s.sendto(frame, (self.host, self.port))
        except OSError:
            return None
        return frame
