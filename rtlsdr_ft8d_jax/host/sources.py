"""Sample sources for the daemon: RTL-SDR hardware, files, synthetic.

The reference binds directly to librtlsdr (C5, /root/reference/
rtlsdr_ft8d.c:1210-1290: open, direct-sampling for HF, 2.4 Msps, gain, ppm,
center = dial + offset + upconverter + fs/4 + 1500 Hz, async read pump).
Here the same device contract is implemented as a ctypes binding that loads
librtlsdr when present; without hardware the daemon runs from file or
synthetic sources through the identical ingest path (native ring buffer ->
int8 fs/4 mixer -> device decimator).
"""

import ctypes
import ctypes.util
import threading

import numpy as np

from ..protocol.constants import CAPTURE_RATE

FS4_OFFSET = CAPTURE_RATE // 4      # 600 kHz (c:1278)
BASEBAND_OFFSET = 1500              # reference tunes dial + 1500 (c:1278)
DEFAULT_BUF_LENGTH = 4 * 16384      # c h:39


class SourceError(RuntimeError):
    pass


class RtlSdrSource:
    """librtlsdr-backed 2.4 Msps IQ source (requires the shared library)."""

    def __init__(self, device_index=0, dial_freq_hz=14_074_000, gain=29,
                 autogain=False, ppm=0, direct_sampling=0, offset=0,
                 upconverter=0):
        path = ctypes.util.find_library("rtlsdr")
        if not path:
            raise SourceError(
                "librtlsdr not found — install librtlsdr or use a file/"
                "synthetic source")
        self.lib = ctypes.CDLL(path)
        self._cfg = dict(device_index=device_index,
                         dial_freq_hz=dial_freq_hz, gain=gain,
                         autogain=autogain, ppm=ppm,
                         direct_sampling=direct_sampling, offset=offset,
                         upconverter=upconverter)
        self._cb_type = ctypes.CFUNCTYPE(
            None, ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint32,
            ctypes.c_void_p)
        self._thread = None
        self._on_samples = None
        self.dev = None
        self._open_and_configure()

    def _check(self, rc, what):
        if rc != 0:
            raise SourceError(f"rtlsdr_{what} failed (rc={rc})")

    def _open_and_configure(self):
        """Full device setup contract (reference c:1210-1290), with every
        return code checked — the reference exits on first error; here
        failures raise SourceError so the daemon can retry/reopen."""
        c = self._cfg
        self.dev = ctypes.c_void_p()
        self._check(self.lib.rtlsdr_open(ctypes.byref(self.dev),
                                         c["device_index"]),
                    f"open device {c['device_index']}")
        real_freq = c["dial_freq_hz"] + c["offset"] + c["upconverter"]
        if c["direct_sampling"]:
            self._check(self.lib.rtlsdr_set_direct_sampling(
                self.dev, c["direct_sampling"]), "set_direct_sampling")
        self._check(self.lib.rtlsdr_set_sample_rate(self.dev, CAPTURE_RATE),
                    "set_sample_rate")
        if c["autogain"]:
            self._check(self.lib.rtlsdr_set_tuner_gain_mode(self.dev, 0),
                        "set_tuner_gain_mode(auto)")
        else:
            self._check(self.lib.rtlsdr_set_tuner_gain_mode(self.dev, 1),
                        "set_tuner_gain_mode(manual)")
            self._check(self.lib.rtlsdr_set_tuner_gain(
                self.dev, c["gain"] * 10), "set_tuner_gain")
        if c["ppm"]:
            self._check(self.lib.rtlsdr_set_freq_correction(
                self.dev, c["ppm"]), "set_freq_correction")
        # reference center frequency recipe (c:1278)
        center = real_freq + FS4_OFFSET + BASEBAND_OFFSET
        self._check(self.lib.rtlsdr_set_center_freq(self.dev, center),
                    "set_center_freq")
        self._check(self.lib.rtlsdr_reset_buffer(self.dev), "reset_buffer")

    def start(self, on_samples):
        """on_samples(np.uint8 interleaved IQ) called from the pump thread."""
        self._on_samples = on_samples

        def cb(buf, length, _ctx):
            data = np.ctypeslib.as_array(buf, shape=(length,)).copy()
            on_samples(data)

        self._cb = self._cb_type(cb)

        def pump():
            self.lib.rtlsdr_read_async(self.dev, self._cb, None, 0,
                                       DEFAULT_BUF_LENGTH)

        self._thread = threading.Thread(target=pump, daemon=True)
        self._thread.start()

    def restart(self):
        """Close and fully reopen a failed/stalled device, resuming the
        pump with the same callback (the reference has no recovery path —
        every device error exits, c:1224-1290)."""
        try:
            self.stop()
        except Exception:
            pass
        self._open_and_configure()
        if self._on_samples is not None:
            self.start(self._on_samples)

    def stop(self):
        if self.dev is None:
            return
        self.lib.rtlsdr_cancel_async(self.dev)
        if self._thread:
            self._thread.join(timeout=5)
            if self._thread.is_alive():
                # rtlsdr_read_async has not returned: closing the handle
                # now would free it out from under the in-flight read
                # (use-after-free in librtlsdr). Leak the handle instead
                # and let the wedged thread die with the process.
                raise SourceError(
                    "pump thread did not exit within 5 s; "
                    "leaving device handle open")
        self.lib.rtlsdr_close(self.dev)
        self.dev = None


class SyntheticSource:
    """Full-rate synthetic source for daemon integration tests.

    Emits 2.4 Msps unsigned-8 interleaved IQ containing an FT8 burst at
    +fs/4 + baseband_hz — exactly what the RTL delivers with the
    reference's tuning recipe — so the whole ingest chain (u8 -> int8 ->
    fs/4 mixer -> polyphase decimator -> decode) is exercised.
    """

    def __init__(self, message="CQ K1JT FN20QI", baseband_hz=500.0,
                 amplitude=0.4, noise_sigma=0.01, seed=1):
        from ..protocol.constants import BLOCK_SIZE, DOWNSAMPLING, \
            TONE_SPACING_HZ
        from ..protocol.encode import encode
        from ..protocol.pack import pack77

        tones = encode(pack77(message))
        rng = np.random.default_rng(seed)
        n = 15 * CAPTURE_RATE
        x = np.zeros(n, dtype=np.complex64)
        sps = BLOCK_SIZE * DOWNSAMPLING
        phi = 0.0
        idx = 0
        for tone in tones:
            f = FS4_OFFSET + baseband_hz + (float(tone) - 3.5) \
                * TONE_SPACING_HZ
            dphi = 2 * np.pi * f / CAPTURE_RATE
            ph = phi + dphi * np.arange(sps)
            x[idx:idx + sps] = amplitude * np.exp(1j * ph)
            phi = (phi + dphi * sps) % (2 * np.pi)
            idx += sps
        x += noise_sigma * (rng.standard_normal(n)
                            + 1j * rng.standard_normal(n)).astype(
                                np.complex64)
        u8 = np.empty(2 * n, dtype=np.uint8)
        u8[0::2] = np.clip(np.real(x) * 127 + 128, 0, 255).astype(np.uint8)
        u8[1::2] = np.clip(np.imag(x) * 127 + 128, 0, 255).astype(np.uint8)
        self._data = u8
        self._pos = 0

    def read(self, n_samples):
        """Return the next n interleaved-IQ samples (2n bytes), looping."""
        out = np.empty(2 * n_samples, dtype=np.uint8)
        filled = 0
        while filled < 2 * n_samples:
            take = min(2 * n_samples - filled,
                       self._data.shape[0] - self._pos)
            out[filled:filled + take] = self._data[self._pos:
                                                   self._pos + take]
            self._pos = (self._pos + take) % self._data.shape[0]
            filled += take
        return out
