"""Chunked streaming replay of precursor driver files.

The reference's `lchunkread` path (moddriver.f90:933 readdriverfile_chunk,
live call site modboundary.f90:263 driverchunkread) keeps only
`chunkread_size` (modglobal.f90:457-458, default 100) time planes of the
precursor series in memory and reads the next chunk from disk when the
simulation time crosses the window.

Device design: the device holds a fixed-shape rolling window
(`DriverWindow`, a State leaf) so the jitted step never recompiles on a
refill — the host `DriverStream` swaps the window arrays between step
dispatches (same shapes, new values).  The full timestamp vector stays on
host; only `chunk` planes of each variable live in HBM at any moment, so a
`driverstore = 10_000`-plane production series replays at bounded device
memory.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from .driverfiles import read_driver_files


class DriverStream:
    """Host-side chunk reader + device-window manager for driver replay."""

    def __init__(self, ddir: str | Path, driverjobnr: int, jtot: int,
                 ktot: int, dtype, chunk: int = 100,
                 driverstore: int | None = None, nsv: int = 0,
                 ltempeq: bool = True, lmoist: bool = False):
        self.ddir = Path(ddir)
        self.jobnr = driverjobnr
        self.jtot, self.ktot = jtot, ktot
        self.dtype = dtype
        self.nsv = nsv
        self.ltempeq, self.lmoist = ltempeq, lmoist
        exp = f"{driverjobnr:03d}"
        t = np.frombuffer((self.ddir / f"tdriver_000.{exp}").read_bytes(),
                          "<f8")
        if driverstore:
            t = t[:driverstore]
        self.t_all = np.asarray(t)
        self.nt = len(t)
        self.chunk = min(max(int(chunk), 4), self.nt)
        self.n0: int | None = None   # current window start record

    def _window(self, n0: int):
        """Load records [n0, n0+chunk) to a DriverWindow of jnp arrays."""
        import jax.numpy as jnp
        from ..ops.openbc import DriverWindow
        d = read_driver_files(self.ddir, self.jobnr, self.jtot, self.ktot,
                              driverstore=self.chunk, start=n0,
                              nsv=self.nsv, ltempeq=self.ltempeq,
                              lmoist=self.lmoist)
        W, ny, nz = self.chunk, self.jtot, self.ktot
        j = lambda a: jnp.asarray(a, self.dtype)
        zero = lambda: jnp.zeros((W, ny, nz), self.dtype)
        return DriverWindow(
            t=j(d["t"]), u=j(d["u"]), v=j(d["v"]), w=j(d["w"]),
            thl=j(d["thl"]) if "thl" in d else zero(),
            qt=j(d["qt"]) if "qt" in d else zero(),
            sv=(j(d["sv"]) if "sv" in d
                else jnp.zeros((W, 0, ny, nz), self.dtype)))

    def _pick_n0(self, timee: float) -> int:
        idx = int(np.searchsorted(self.t_all, timee, side="right")) - 1
        return int(np.clip(idx - 1, 0, self.nt - self.chunk))

    def ensure(self, state):
        """Return `state` with a window covering `state.timee` (+ margin);
        loads a fresh chunk only when the time has crossed the window.
        Called between jitted step dispatches (host-side; the comparison
        syncs timee, which the Simulation loop does anyway)."""
        timee = float(state.timee)
        if self.n0 is not None:
            hi = min(self.n0 + self.chunk - 2, self.nt - 2)
            if timee < self.t_all[hi] or self.n0 >= self.nt - self.chunk:
                return state if state.drv is not None \
                    else state.replace(drv=self._window(self.n0))
        self.n0 = self._pick_n0(timee)
        return state.replace(drv=self._window(self.n0))
