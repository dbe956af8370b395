"""What every driver (``drivers/<kind>.py``) shares.

A driver's ``Cell`` builds the system under test in ``setup``, runs the
traffic in ``window`` (returning the end-to-end values it measured),
frees the program's state in ``release`` and judges what the window
produced against the plain reference in ``judge``.  A training cell's
driver defines ``_step`` and uses ``judged_steps``, ``record_change``
and ``train_window``.  ``layer_ctx`` hands
the per-layer readers the counts they read.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Callable, Dict, List, Sequence


class CellBase:
    def __init__(self, cfg: Dict, mix: Dict, seed: int, device, spans,
                 log=print):
        self.cfg, self.mix, self.seed = cfg, mix, int(seed)
        self.device, self.spans, self.log = device, spans, log
        self.on_card = device.type == "cuda"
        # seconds of set-up spent on the reference's own steps, left out
        # of setup_s
        self.check_setup_s = 0.0
        self.window_s = 0.0
        self.attempted = 0
        self.failed = 0

    # what a driver may leave as it is
    def captures(self) -> int:
        return 0

    def memory_note(self) -> str:
        return ""

    def layer_ctx(self) -> Dict:
        return {}

    def sync(self) -> None:
        if self.on_card:
            import torch

            torch.cuda.synchronize(self.device)

    def free_card(self) -> None:
        gc.collect()
        if self.on_card:
            import torch

            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def judged_steps(self, read_first: Callable[[], None],
                     keys: Sequence[str] = ("loss",)) -> List[Dict]:
        """A training cell's first ``judged_steps`` steps in set-up, through
        the window's own call and feed (``_step``): each step's ``keys``
        read at once (a graph's outputs are overwritten by the next
        replay), the losses kept in ``first["loss"]``.  ``read_first``
        reads the optimizer's state after step 1, timed as the check's
        and not as set-up."""
        self.first = {"loss": []}
        got = []
        for i in range(self.mix["judged_steps"]):
            m = self._step()
            got.append({k: float(m[k]) for k in keys})
            self.first["loss"].append(got[-1]["loss"])
            if i == 0:
                t = now()
                read_first()
                self.check_setup_s += now() - t
        return got

    def record_change(self, leaves_at_start: Callable[[], Dict],
                      leaves_now: Dict) -> None:
        """``first["change"]``: each leaf's change over the judged steps,
        against the seed's weights drawn anew, timed as the check's."""
        import torch

        t = now()
        p0 = leaves_at_start()
        self.first["change"] = {
            n: float(torch.linalg.vector_norm(v - p0[n]))
            for n, v in leaves_now.items()}
        del p0
        self.sync()
        self.check_setup_s += now() - t

    def train_window(self, seconds: float, name: str) -> Dict[str, float]:
        """A training cell's window: ``_step`` until ``seconds`` have
        passed, one step in flight (each step's loss read after the next
        is launched); ``name`` is the window's whole time over its steps,
        in ms."""
        losses, n, prev = [], 0, None
        with self.spans.span("measured"):
            t0 = now()
            while True:
                m = self._step()
                n += 1
                if prev is not None:
                    with self.spans.span("sync"):
                        losses.append(float(prev["loss"]))
                prev = m
                if now() - t0 >= seconds:
                    break
            with self.spans.span("sync"):
                losses.append(float(prev["loss"]))
            t = now()
        self.window_s = t - t0
        self.attempted = self.steps = n
        self.failed = sum(not math.isfinite(x) for x in losses)
        self.log(f"trained: {n} steps in {self.window_s:.3f} s | loss "
                 f"{losses[0]:.4f} -> {losses[-1]:.4f}")
        return {name: self.window_s / n * 1e3}

    def checks(self, values: Dict[str, float]) -> Dict[str, Dict]:
        """Each number compared beside the limit the traffic file gives it:
        within the limit when ``value <= limit`` (a NaN never is)."""
        limits = self.mix["checks"]
        out = {}
        for name, limit in limits.items():
            v = float(values[name])
            out[name] = {"value": v, "limit": float(limit),
                         "ok": (not math.isnan(v)) and v <= float(limit)}
        return out


def now() -> float:
    return time.perf_counter()


def generator_seed(seed: int, salt: int = 0) -> int:
    """A torch generator seed from any whole ``seed`` (the driver's can
    pass 2**31) and a ``salt``, within the 64 bits a generator takes."""
    return (int(seed) * 1_000_003 + int(salt)) % (1 << 63)
