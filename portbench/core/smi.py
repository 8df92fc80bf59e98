"""nvidia-smi sampled beside the window: clocks, power draw, power limit
and temperature once a second, in a process started before the window
and stopped (and waited for) after it."""

from __future__ import annotations

import subprocess

QUERY = "name,clocks.sm,clocks.mem,power.draw,power.limit,temperature.gpu"


class Sampler:
    def __init__(self, period_ms: int = 1000):
        self.proc = None
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", f"--query-gpu={QUERY}",
                 "--format=csv,noheader", f"-lms={period_ms}"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                text=True)
        except OSError:
            self.proc = None

    def stop(self) -> list:
        """The samples, one line each (none where nvidia-smi is absent)."""
        if self.proc is None:
            return []
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        return [ln.strip() for ln in out.splitlines() if ln.strip()]


def card_line() -> str:
    """The card's name and power limit."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "nvidia-smi not available"
