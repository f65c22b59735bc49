"""Gazepoint eye-tracker client (human data collection hardware path; the
port's copy of gabril_carla_tpu/io/gazepoint.py).

Parity with vlm_gaze/eval/sensor.py:6-62: TCP connection to the Gazepoint
Control server, ENABLE_SEND_POG_FIX handshake, and FPOGX/FPOGY extraction
from the XML record stream. Invalid samples (FPOGV=0 or out-of-range) are
filtered by the caller holding the last valid point
(eval/my_agents/human_agent.py:203-206).
"""

from __future__ import annotations

import re
import socket

_FPOG = re.compile(r'FPOG([XYV])="([-0-9.]+)"')


def parse_gazepoint_records(payload: str) -> list[tuple[float, float, bool]]:
    """XML record stream -> [(x, y, valid)] in [0,1] screen coordinates."""
    out = []
    for rec in payload.split("<REC"):
        fields = dict(_FPOG.findall(rec))
        if "X" in fields and "Y" in fields:
            x, y = float(fields["X"]), float(fields["Y"])
            valid = fields.get("V", "1") not in ("0", "0.0")
            valid = valid and 0.0 <= x <= 1.0 and 0.0 <= y <= 1.0
            out.append((x, y, valid))
    return out


class GazepointClient:
    """Minimal blocking client; one sample per poll()."""

    ENABLE = b'<SET ID="ENABLE_SEND_POG_FIX" STATE="1" />\r\n<SET ID="ENABLE_SEND_DATA" STATE="1" />\r\n'

    def __init__(self, host: str = "127.0.0.1", port: int = 4242, timeout: float = 1.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.sendall(self.ENABLE)
        self._buf = ""
        self.last_valid: tuple[float, float] = (0.5, 0.5)

    def poll(self) -> tuple[float, float, bool]:
        """Latest fixation; holds the last valid point on invalid samples."""
        try:
            self._buf += self.sock.recv(4096).decode("ascii", errors="ignore")
        except socket.timeout:
            return (*self.last_valid, False)
        records = parse_gazepoint_records(self._buf)
        self._buf = self._buf[-512:]
        for x, y, valid in reversed(records):
            if valid:
                self.last_valid = (x, y)
                return x, y, True
        return (*self.last_valid, False)

    def close(self):
        self.sock.close()
