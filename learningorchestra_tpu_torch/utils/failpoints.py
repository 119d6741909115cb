"""Deterministic fault injection — named failpoints through the data plane.

The chaos coverage before this module was whole-process SIGKILL at one
site (tests/chaos_child.py): it proved the pod supervisor works, but said
nothing about torn writes, bit rot, or crashes at *specific* I/O
boundaries inside the chunk store. This is the Jepsen/TiKV-style
failpoint idiom: modules *declare* named injection sites at import time
(``declare("catalog.write_chunk.pre_rename")``) and call
``fire(site, path=...)`` at the guarded operation; tests (or an operator
reproducing a bug) activate sites via

    LO_TPU_FAILPOINTS=site=mode[:nth][,site2=mode2[:nth2]...]

with modes

- ``raise``   — raise :class:`FailpointError` (tests the error path);
- ``crash``   — ``os._exit(41)`` (the kill-at-this-exact-syscall chaos
  the sweep in tests/test_failpoints.py drives through a child process);
- ``hang``    — block ~1 hour (wedge detection / timeout paths);
- ``torn``    — truncate the in-flight file named by ``path`` to half
  its bytes (a torn write that later surfaces as corruption);
- ``bitflip`` — flip one bit mid-file in ``path`` (bit rot);
- ``slow``    — sleep :data:`SLOW_S` seconds (a stall long enough to
  breach any realistic deadline budget without wedging the suite the
  way ``hang`` would — the serving deadline chaos tests lean on it).

``nth`` (default 1) arms the site on its Nth hit — one-shot: after
firing, the site deactivates, so a recovery path re-entering the same
code cannot re-trip it. ``nth`` of **0** arms the site PERSISTENTLY —
it fires on *every* hit and never deactivates: how the dispatcher
quarantine chaos test makes a supervised restart crash again on each
attempt.

Zero overhead when unset: ``fire`` is a single attribute test on a
module-level flag that is False unless the env var (or ``configure``)
armed at least one site. The registry is introspectable (``sites()``)
so the failpoint sweep can enumerate every declared site instead of
hard-coding a list that silently rots.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

ENV_VAR = "LO_TPU_FAILPOINTS"

#: Exit code for ``crash`` mode — distinguishable from interpreter errors
#: (1) and signals, so the sweep asserts the failpoint (and nothing else)
#: killed the child.
CRASH_EXIT_CODE = 41

_MODES = ("raise", "crash", "hang", "torn", "bitflip", "slow")

#: ``slow`` mode's stall length — long past any sane request deadline
#: budget, short enough that a test leaking one costs seconds, not the
#: suite timeout.
SLOW_S = 2.0


class FailpointError(RuntimeError):
    """Raised by an armed ``raise``-mode failpoint."""


class _Armed:
    __slots__ = ("mode", "nth", "hits", "fired")

    def __init__(self, mode: str, nth: int):
        self.mode = mode
        self.nth = nth
        self.hits = 0
        self.fired = False


_lock = threading.Lock()
_declared: Dict[str, int] = {}      # site -> total hit count (introspection)
_armed: Dict[str, _Armed] = {}
#: Fast-path flag: ``fire`` returns immediately while this is False.
_active = False


def declare(site: str) -> str:
    """Register a failpoint site (module import time). Idempotent;
    returns the site name so call sites can bind it to a constant."""
    with _lock:
        _declared.setdefault(site, 0)
    return site


def sites(prefix: str = "") -> List[str]:
    """All declared sites (optionally filtered by prefix) — the sweep's
    enumeration source."""
    with _lock:
        return sorted(s for s in _declared if s.startswith(prefix))


def hit_counts() -> Dict[str, int]:
    """Site -> times ``fire`` reached it (armed or not) this process."""
    with _lock:
        return dict(_declared)


def parse_spec(spec: str) -> Dict[str, _Armed]:
    """``site=mode[:nth],...`` -> armed map. Raises ValueError on a bad
    mode/count so a typo'd env var fails loudly, not silently-no-op."""
    out: Dict[str, _Armed] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"bad failpoint spec {part!r}: want site=mode")
        site, _, modespec = part.partition("=")
        mode, _, nth_s = modespec.partition(":")
        if mode not in _MODES:
            raise ValueError(
                f"unknown failpoint mode {mode!r} (want one of {_MODES})")
        nth = int(nth_s) if nth_s else 1
        if nth < 0:
            raise ValueError(
                f"failpoint nth must be >= 0 (0 = every hit), got {nth}")
        out[site.strip()] = _Armed(mode, nth)
    return out


def configure(spec: Optional[str]) -> None:
    """Arm sites from a spec string (tests); ``None``/"" disarms all."""
    global _active
    with _lock:
        _armed.clear()
        if spec:
            _armed.update(parse_spec(spec))
        _active = bool(_armed)


def reset() -> None:
    """Disarm everything and zero hit counters (test isolation)."""
    global _active
    with _lock:
        _armed.clear()
        for site in _declared:
            _declared[site] = 0
        _active = False


def _load_env() -> None:
    # Local import: config is the single home of LO_TPU_* reads
    # (lolint env-discipline), and importing it lazily keeps this
    # module free of package imports at its own import time.
    from learningorchestra_tpu_torch.config import failpoint_spec

    spec = failpoint_spec()
    if spec:
        configure(spec)


def _corrupt_torn(path: str) -> None:
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(max(size // 2, 1))
        f.flush()
        os.fsync(f.fileno())


def _corrupt_bitflip(path: str) -> None:
    size = os.path.getsize(path)
    pos = size // 2
    with open(path, "r+b") as f:
        f.seek(pos)
        byte = f.read(1)
        flipped = bytes([(byte[0] ^ 0x01) if byte else 0x01])
        f.seek(pos)
        f.write(flipped)
        f.flush()
        os.fsync(f.fileno())


def fire(site: str, path: Optional[str] = None) -> None:
    """Hit a failpoint site. No-op (one flag test) unless armed.

    ``path`` names the in-flight file ``torn``/``bitflip`` corrupt; an
    armed file mode at a site that passes no path fires as ``raise``
    instead (a misconfiguration should fail the test loudly, not no-op).
    """
    if not _active:
        return
    with _lock:
        if site in _declared:
            _declared[site] += 1
        armed = _armed.get(site)
        if armed is None or armed.fired:
            return
        armed.hits += 1
        if armed.hits < armed.nth:
            return
        if armed.nth > 0:                 # nth=0 = persistent: every hit
            armed.fired = True
        mode = armed.mode
    if mode == "crash":
        # Skip interpreter teardown entirely — the point is the state
        # the OS sees at this exact syscall boundary.
        os._exit(CRASH_EXIT_CODE)
    if mode == "hang":
        time.sleep(3600.0)
        return
    if mode == "slow":
        time.sleep(SLOW_S)
        return
    if mode in ("torn", "bitflip") and path is not None \
            and os.path.isfile(path):
        (_corrupt_torn if mode == "torn" else _corrupt_bitflip)(path)
        return
    raise FailpointError(f"failpoint fired: {site} ({mode})")


_load_env()
